"""What the benchmark's tests know of traffic kind ``experiment_steps``
(``benchmark/kinds/experiment_steps.py``): the ``experiment`` kind's whole
experiments, kernel B one launch a frame for all runs, frame 0's per-step
losses returned and followed window by window (``benchmark/tests/cells.py``
lists the names a support file holds).

* The control trains and evaluates frame 0 of every run with the
  step-by-step reference in TF32 (``reference.dp_vae.precision("tf32")``),
  one precision below the configuration's float32 with TF32 off, and reads
  the check's frame-0 numbers, the per-step losses' among them, off it as
  off the program's.
* The faults (``FAULTS``): the experiment kind's four, planted in
  ``train/dp.py`` the same way (kernel B's state unchanged, half the runs
  untrained, each frame's soft SER raised by 0.01, the carry dropped), and
  ``windows_halved``: kernel B run at twice the window stride, half the
  windows, each window's results given twice so that the frame keeps its
  shapes. Two of them only a full-size experiment shows
  (``FULL_SIZE_ONLY``): the carry dropped and the SER raised, which the
  final numbers catch; frame 0's SER, which a small run would hold to 0.01,
  parts by more than that over 990 dependent windows, and its limit is
  loose (``PERF.md`` §2).
"""

from __future__ import annotations

import contextlib

from benchmark.harness import counts
from benchmark.reference import dp_vae_steps as ref
from benchmark.tests.cells import patched
from benchmark.tests.kinds import experiment

# 2 frames of 600 symbols: VAEflex's 50 windows a frame
SMALL_CONFIG = {"num_frames": 2, "n_frame_max": 600}
# the final butterflies' SER needs the whole experiment to converge, which
# the small size does not reach; every other number keeps the cell's limit
UNCONVERGED = ("final_ser", "final_ser_reported")
CPU_SECONDS = 0.5
FAULTS = experiment.FAULTS + ("windows_halved",)
FULL_SIZE_ONLY = experiment.FULL_SIZE_ONLY + ("answer_altered",)


def shrink(spec: dict) -> dict:
    spec["config"].update(SMALL_CONFIG)
    spec["limits"] = {**spec["limits"],
                      "limits": {k: v for k, v in spec["limits"]["limits"].items()
                                 if k not in UNCONVERGED}}
    return spec


def launches(spec: dict) -> list[tuple]:
    return [experiment.kernel_b(counts.b_experiment(spec["config"], spec["mix"]))]


def control(spec: dict, seed: int, device: str, seconds: float = 0.0) -> dict:
    """The numbers with the TF32 reference in the program's place: frame 0
    of experiment 1 of ``seed``. It runs no window (``seconds`` unused)."""
    kind = spec["kind"]
    s = kind.experiment_seed(seed, 1)
    got = ref.frame0(spec["config"], s, spec["mix"]["runs"], device, "tf32")
    want = ref.frame0(spec["config"], s, spec["mix"]["runs"], device, "float32")
    out = kind.gaps(got, want)
    out["frame0_loss_rel"] = kind.loss_gap(got["losses"], want["losses"],
                                           spec["limits"]["loss_windows"])
    return out


def tested_control(spec: dict, seed: int, device: str) -> dict:
    return control(spec, seed, device)


def b_halved(b):
    """Kernel B at twice the window stride: half the windows, each window's
    losses and streams repeated, so the frame's shapes stay as they were."""
    def fault(*args, stride_sym=None, **kw):
        w, h, opt, *rest = b(*args, stride_sym=2 * stride_sym, **kw)
        return (w, h, opt, *(t.repeat_interleave(2, dim=0) for t in rest))
    return fault


@contextlib.contextmanager
def fault(name: str):
    """Break the experiments' timed path for the block's duration."""
    from vae_equalizer_tpu_torch.train import dp

    if name == "windows_halved":
        plant = patched(dp, "vae_dp_frame_train", b_halved(dp.vae_dp_frame_train))
    else:  # the experiment kind's, or its error for a name it does not plant
        plant = experiment.fault(name)
    with plant:
        yield
