"""Traffic kind ``experiment_steps``: the ``experiment`` kind's whole
online-training experiments (``benchmark/kinds/experiment.py``: the same
mix parameters, seeds, warm-up, window and ``symbols_per_s``), each runner
call asked for frame 0's per-step losses (``frame0_losses=True``), which
the check follows step by step.

It is for configurations whose frame is too many dependent steps for frame
0's end results to tell a sound run from one a precision lower: VAEflex's
990 overlapping windows a frame, from the Dirac start, part as far from the
reference as TF32 does by the frame's end. The first windows do not: the
reference (``benchmark/reference/dp_vae_steps.py``) trains frame 0 window
by window as the program does and keeps each window's loss.

The check adds two numbers to the experiment kind's. ``frame0_loss_rel``:
the worst over runs and over the first ``loss_windows`` windows (the
cell's limits file) of |program - reference| / |reference|, frame 0's
losses of the same draws. ``final_ser_reported``: the worst run's soft SER
of the last frame as the program reports it (the mean of the pols), the
converged equalizer's answer over the frame's windows: a frame's answer
reported wrong, or a frame trained from the start again, reads above the
sound runs' band. (The reference's ``final_ser`` of the final butterflies
on a fresh frame cannot stand in for it: over 990 windows of 100 symbols
Adam leaves the last window's butterflies a noisy snapshot, whose SER
reads 1.2-2.2x the frame's.) A program whose runner has no
``frame0_losses`` option fails at set-up, before any experiment runs.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from benchmark.harness.core import Fail
from benchmark.kinds import experiment
from benchmark.reference import dp_vae as ref
from benchmark.reference import dp_vae_steps as ref_steps

experiment_seed, gaps, program_config = (experiment.experiment_seed, experiment.gaps,
                                         experiment.program_config)


def loss_gap(got: torch.Tensor, want: torch.Tensor, windows: int) -> float:
    """The worst relative gap of frame 0's losses (runs, steps) over runs and
    the first ``windows`` windows."""
    got, want = got[..., :windows].to(want.dtype), want[..., :windows]
    return float(((got - want).abs() / want.abs()).max())


class Cell(experiment.Cell):
    def setup(self) -> None:
        from vae_equalizer_tpu_torch.train import train_vae_dp, train_vae_flex_dp

        entry = train_vae_dp if self.cfg["loss_type"] == "VAE" else train_vae_flex_dp
        if "frame0_losses" not in inspect.signature(entry).parameters:
            raise Fail(f"the program's {entry.__name__} has no frame0_losses option: this "
                       "kind reads frame 0's per-step losses")
        super().setup()

    def call(self, seed: int) -> dict:
        return self.entry(self.pcfg, seed, device=self.device, runs=self.mix["runs"],
                          use_pallas=self.mix["use_pallas"], compiled=self.mix["compiled"],
                          frame0_losses=True)

    def _experiment(self, k: int) -> None:
        s = experiment_seed(self.seed, k)
        with torch.profiler.record_function("bench.experiment"):
            res = self.call(s)
        self._sync()
        rows = {key: res[key][..., 0] for key in ("ser", "mi", "var_est")}
        rows["losses"] = res["frame0_losses"]
        rows["ser_last"] = res["ser"][..., 2:, -1].mean(-1)  # the last frame's soft SER
        self.done.append((s, rows, res["params"]["w"]))

    def readings(self, seed: int, rows: dict, w: torch.Tensor) -> dict:
        """The experiment kind's numbers, with frame 0 from the step-by-step
        reference, ``frame0_loss_rel`` and ``final_ser_reported``."""
        want = ref_steps.frame0(self.cfg, seed, self.mix["runs"], self.device)
        dev = want["ser"].device
        got = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in rows.items()}
        out = gaps(got, want)
        out["frame0_loss_rel"] = loss_gap(got["losses"], want["losses"],
                                          self.limits["loss_windows"])
        final = ref.eval_params(self.cfg, w.detach().float(), seed ^ 0x5EED,
                                self.cfg["num_frames"] - 1)
        out["final_ser"] = float(final.mean(-1).max())
        out["final_ser_reported"] = float(got["ser_last"].max())
        return out
