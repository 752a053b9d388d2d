"""What the benchmark's tests know of traffic kind ``sweep``
(``benchmark/kinds/sweep.py``): whole SNR-curve sweeps through the
program's sweep engine, every point's repeats batched as the runs of one
call, kernels B and K one launch a frame for all runs
(``benchmark/tests/cells.py`` lists the names a support file holds).

* The control trains and evaluates frame 0 of every run of a sweep's call
  with the plain reference in TF32 (``reference.dp_vae.precision("tf32")``),
  one precision below the configuration's float32 with TF32 off, and reads
  the check's frame-0 gaps and the variance off it as off the program's.
* The faults (``FAULTS``): the experiment kind's four, planted in
  ``train/dp.py`` the same way (kernel B's state unchanged, half the runs
  untrained, each frame's soft SER raised by 0.01, the carry dropped, which
  only a full-size sweep's final butterflies show: ``FULL_SIZE_ONLY``), and
  two of the sweep's own: every run at the group's first SNR, in the
  channel and the demapper (``train/dp.py: _run_consts``); and point j's
  record cut from point j + 1's runs (``parallel/sweep.py: _point_result``).
"""

from __future__ import annotations

import contextlib

import numpy as np

from benchmark.harness import counts_sweep
from benchmark.reference import dp_vae_sweep as ref
from benchmark.tests.cells import patched
from benchmark.tests.kinds import experiment

# 2 SNR points x 2 repeats, 2 frames of 2,000 symbols (20 minibatch steps a frame)
SMALL_CONFIG = {"num_frames": 2, "n_frame_max": 2000, "snr_grid_db": [16.0, 23.0]}
SMALL_MIX = {"iters": 2}
# the final butterflies' SER needs the whole sweep to converge, which the
# small size does not reach; every other number keeps the cell's limit
UNCONVERGED = ("final_ser_excess",)
CPU_SECONDS = 0.5
FAULTS = experiment.FAULTS + ("snr_shared", "records_shifted")
FULL_SIZE_ONLY = experiment.FULL_SIZE_ONLY


def shrink(spec: dict) -> dict:
    spec["config"].update(SMALL_CONFIG)
    spec["mix"].update(SMALL_MIX)
    spec["limits"] = {**spec["limits"],
                      "limits": {k: v for k, v in spec["limits"]["limits"].items()
                                 if k not in UNCONVERGED}}
    return spec


def _plain_b(shape: dict):
    """Kernel B's plain version on the meta device (shapes only) at a launch
    of ``shape`` with a variance per run: (its arguments, its results)."""
    import torch

    from vae_equalizer_tpu_torch.ops.frame_kernel import vae_dp_frame_train_plain

    s = shape
    R, m = s["runs"], s["m"]
    meta = lambda *size: torch.empty(size, device="meta")  # noqa: E731
    args = (meta(R, 2, 4, m), meta(R, 2, 2, 2, m),
            {"mw": meta(R, 2, 4, m), "vw": meta(R, 2, 4, m), "mh": meta(R, 2, 2, 2, m),
             "vh": meta(R, 2, 2, 2, m)},
            meta(R, 2, 2, s["n_samp"]), meta(s["n_lev"]), meta(R, 2), 0.0, meta(s["n_lev"]),
            2.5e-3, 0, float("inf"))
    return args, vae_dp_frame_train_plain(*args, bl_sym=s["bl"])


def _kernel_b(shape: dict, plain: tuple) -> tuple:
    """Kernel B's launch of ``shape`` in ``cells.check_counts``' form: its
    operations held to ``chip_smoke._dp_step_flops`` and Adam's 12 a
    parameter, its bytes to ``chip_smoke._nbytes`` of the plain version's
    arguments and results ``plain``."""
    import chip_smoke

    flops = experiment.kernel_b(shape)[2][0]
    return "B", counts_sweep.b_launch(shape), (flops, chip_smoke._nbytes(*plain)), "operations"


def _kernel_k(shape: dict, streams: tuple) -> tuple:
    """Kernel K's launch of ``shape``: its operations held to
    ``chip_smoke._eval_flops``, its bytes to ``chip_smoke._nbytes`` of kernel
    B's ``streams`` (out, dec, eq, mm, s1), tx and K's results, as
    ``chip_smoke.py``'s phase 6b counts them."""
    import chip_smoke
    import torch

    s = shape
    R = s["runs"]
    meta = lambda *size, dtype=torch.float32: torch.empty(  # noqa: E731
        size, dtype=dtype, device="meta")
    results = (meta(R, 2), meta(R, 2), meta(R, 2), meta(R, 2, dtype=torch.int32),
               meta(R, dtype=torch.int32))
    want = (R * chip_smoke._eval_flops(s["n_sym"], s["n_lev"], s["corr_len"]),
            chip_smoke._nbytes(streams, meta(R, 2, 2, s["n_sym"]), results))
    return "K", counts_sweep.k_launch(s), want, "bytes"


def launches(spec: dict) -> list[tuple]:
    cfg, mix = spec["config"], spec["mix"]
    b = counts_sweep.b_sweep(cfg, mix)
    plain = _plain_b(b)
    return [_kernel_b(b, plain), _kernel_k(counts_sweep.k_sweep(cfg, mix), plain[1][5:10])]


def control(spec: dict, seed: int, device: str, seconds: float = 0.0) -> dict:
    """The numbers with the TF32 reference in the program's place: frame 0
    of every run of sweep 1 of ``seed``. It runs no window (``seconds`` unused)."""
    kind, cfg, iters = spec["kind"], spec["config"], spec["mix"]["iters"]
    s = ref.group_seed(kind.experiment_seed(seed, 1), 0)
    snrs = cfg["snr_grid_db"]
    got = ref.frame0(cfg, s, snrs, iters, device, "tf32")
    want = ref.frame0(cfg, s, snrs, iters, device, "float32")
    out = kind.gaps(got, want)
    out["var_rel"] = float(((got["var"] - want["var"]).abs() / want["var"]).max())
    return out


def tested_control(spec: dict, seed: int, device: str) -> dict:
    return control(spec, seed, device)


def _first_snr(run_consts):
    """``_run_consts`` with every run's SNR the first run's."""
    def fault(cfg, const, var, runs, lr_vec, snr_vec, nu_vec, device):
        if snr_vec is not None:
            snr_vec = np.full_like(np.asarray(snr_vec), np.asarray(snr_vec).reshape(-1)[0])
        return run_consts(cfg, const, var, runs, lr_vec, snr_vec, nu_vec, device)
    return fault


def _next_point(point_result):
    """``_point_result`` giving point j the runs of point j + 1 (the last the first's)."""
    def fault(res, bj, iters):
        return point_result(res, (bj + 1) % (np.asarray(res["ser"]).shape[0] // iters), iters)
    return fault


@contextlib.contextmanager
def fault(name: str):
    """Break the sweeps' timed path for the block's duration."""
    from vae_equalizer_tpu_torch.parallel import sweep
    from vae_equalizer_tpu_torch.train import dp

    if name == "snr_shared":
        plant = patched(dp, "_run_consts", _first_snr(dp._run_consts))
    elif name == "records_shifted":
        plant = patched(sweep, "_point_result", _next_point(sweep._point_result))
    elif name in experiment.FAULTS:
        plant = experiment.fault(name)
    else:
        raise ValueError(f"unknown fault {name!r} of kind sweep")
    with plant:
        yield
