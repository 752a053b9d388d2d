"""What the benchmark's tests know of traffic kind ``experiment``
(``benchmark/kinds/experiment.py``): whole DP VAE experiments, kernel B one
launch a frame for all runs (``benchmark/tests/cells.py`` lists the names a
support file holds).

* The control trains and evaluates frame 0 of every run with the plain
  reference in TF32 (``reference.dp_vae.precision("tf32")``), one
  precision below the configuration's float32 with TF32 off, and reads the
  check's frame-0 gaps off it as off the program's.
* The faults (``FAULTS``), planted in ``train/dp.py``: kernel B returning
  the state it was given (lr 0, its Adam moments given back); half of the
  runs of each launch left untrained; each frame's soft SER raised by 0.01;
  the carry dropped (every frame's launch from the Dirac taps with zero
  moments at step 0), which only the final butterflies of a converged,
  full-size experiment show (``FULL_SIZE_ONLY``).
  ``optimizer_restarted``, not among ``FAULTS``, drops only a frame's Adam
  moments and step count: restarted Adam converges as well, and no number
  of the check reads it (PERF.md).
"""

from __future__ import annotations

import contextlib

import torch

from benchmark.harness import counts
from benchmark.reference import dp_vae as ref
from benchmark.tests.cells import patched

# 2 frames of 2,000 symbols (20 minibatch steps a frame)
SMALL_CONFIG = {"num_frames": 2, "n_frame_max": 2000}
# the final butterflies' SER needs the whole experiment to converge, which
# the small size does not reach; every other number keeps the cell's limit
UNCONVERGED = ("final_ser",)
CPU_SECONDS = 0.5
FAULTS = ("state_unchanged", "half_batch", "answer_altered", "carry_dropped")
FULL_SIZE_ONLY = ("carry_dropped",)


def shrink(spec: dict) -> dict:
    spec["config"].update(SMALL_CONFIG)
    spec["limits"] = {"limits": {k: v for k, v in spec["limits"]["limits"].items()
                                 if k not in UNCONVERGED}}
    return spec


def kernel_b(shape: dict) -> tuple:
    """Kernel B's launch of ``shape`` in ``cells.check_counts``' form: its
    operations held to ``chip_smoke._dp_step_flops`` and Adam's 12 a
    parameter (phase 4b); its bytes to ``chip_smoke._nbytes`` by
    ``test_counts.py: test_bytes_equal_chip_smoke``."""
    import chip_smoke

    s = shape
    want = s["runs"] * s["steps"] * (chip_smoke._dp_step_flops(s["bl"], s["m"], s["n_lev"])
                                     + 12 * 16 * s["m"])
    return "B", counts.b_launch(s), (want, counts.b_launch_bytes(**s)), "operations"


def launches(spec: dict) -> list[tuple]:
    return [kernel_b(counts.b_experiment(spec["config"], spec["mix"]))]


def control(spec: dict, seed: int, device: str, seconds: float = 0.0) -> dict:
    """The numbers with the TF32 reference in the program's place: frame 0
    of experiment 1 of ``seed``. It runs no window (``seconds`` unused)."""
    kind = spec["kind"]
    s = kind.experiment_seed(seed, 1)
    got = ref.frame0(spec["config"], s, spec["mix"]["runs"], device, "tf32")
    want = ref.frame0(spec["config"], s, spec["mix"]["runs"], device, "float32")
    return kind.gaps(got, want)


def tested_control(spec: dict, seed: int, device: str) -> dict:
    return control(spec, seed, device)


def b_frozen(b, rows=slice(None)):
    """Kernel B whose steps leave the state of runs ``rows`` unchanged: those
    runs train at lr 0 (every step's forward pass and streams from the state
    it was given) and get their Adam moments back as given."""
    def fault(w, h, opt, rx, amps, var, nu_sc, P, lr, *args, **kw):
        R = w.shape[0]
        lr_runs = torch.full((R,), float(lr), device=w.device) if not torch.is_tensor(lr) \
            else lr.expand(R).clone()
        lr_runs[rows] = 0.0
        w2, h2, o2, *rest = b(w, h, opt, rx, amps, var, nu_sc, P, lr_runs, *args, **kw)
        o2 = {k: v.clone() for k, v in o2.items()}
        for k in o2:
            o2[k][rows] = opt[k][rows]
        return (w2, h2, o2, *rest)
    return fault


def _b_fresh_start(b, params: bool):
    """Kernel B from zero Adam moments at step 0 whatever it is given, and
    with ``params`` from the Dirac start too."""
    def fault(w, h, opt, rx, amps, var, nu_sc, P, lr, count, *args, **kw):
        zeros = {k: torch.zeros_like(v) for k, v in opt.items()}
        if params:
            start = ref.dirac(w.shape[-1], w.shape[0], w.device)
            w, h = start["w"], start["h"]
        return b(w, h, zeros, rx, amps, var, nu_sc, P, lr, torch.zeros_like(count), *args, **kw)
    return fault


@contextlib.contextmanager
def fault(name: str):
    """Break the experiments' timed path for the block's duration."""
    from vae_equalizer_tpu_torch.train import dp

    b = dp.vae_dp_frame_train
    if name == "state_unchanged":
        plant = patched(dp, "vae_dp_frame_train", b_frozen(b))
    elif name == "half_batch":
        plant = patched(dp, "vae_dp_frame_train",
                        lambda w, *a, **k: b_frozen(b, slice(w.shape[0] // 2, None))(w, *a, **k))
    elif name == "answer_altered":
        metrics = dp._vae_metrics

        def altered(losses, ser_const, ser_soft, *rest):  # one symbol in a hundred more errors
            return metrics(losses, ser_const, ser_soft + 1e-2, *rest)
        plant = patched(dp, "_vae_metrics", altered)
    elif name in ("carry_dropped", "optimizer_restarted"):
        plant = patched(dp, "vae_dp_frame_train", _b_fresh_start(b, params=name == "carry_dropped"))
    else:
        raise ValueError(f"unknown fault {name!r} of kind experiment")
    with plant:
        yield
