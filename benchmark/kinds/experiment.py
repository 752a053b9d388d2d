"""Traffic kind ``experiment``: whole online-training experiments of the DP
VAE (``train_vae_dp``) or VAEflex (``train_vae_flex_dp``, by the
configuration's ``loss_type``), back to back, each with its own seed.

The mix's parameters: ``runs`` (repeats batched into one experiment),
``use_pallas`` and ``compiled`` (the runner's mode), ``check_experiments``
(how many finished experiments the output check follows). Experiment k's
seed is drawn from the run's ``--seed`` and k, so one seed gives one
sequence of experiments.

Set-up builds the configuration and runs one warm-up experiment of the same
shapes and mode (it builds the kernels on a checkout's first run, cuFFT's
plans and the allocator's pools). The window starts experiments while
``seconds`` have not run out and closes at the end of the last one begun:
``symbols_per_s`` is every symbol trained (runs x frames x symbols a frame)
over the whole window. A traced run profiles one more experiment once the
window has closed, so that the profiler leaves the window alone.

The check, once the window has closed, follows ``check_experiments`` of
the finished experiments, drawn from the seed, with the plain reference
(``benchmark/reference/dp_vae.py``): frame 0 of every run from the same
draws, trained and evaluated anew (the gaps of its SER, MI and noise
variance estimate), and the final butterflies of every run equalizing a
fresh frame at the last frame's angle (their SER).
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time

import numpy as np
import torch

from benchmark.reference import dp_vae as ref


def experiment_seed(seed: int, k: int) -> int:
    """Experiment k's seed (k = 0 is the warm-up), from the run's seed."""
    return int(np.random.SeedSequence([seed % 2**64, k]).generate_state(1)[0] >> 1)


def program_config(cfg: dict):
    """The configuration's sizes as the program's ``DpConfig``."""
    from vae_equalizer_tpu_torch.utils import DpConfig

    fields = {f.name for f in dataclasses.fields(DpConfig)}
    kw = {k: v for k, v in cfg.items() if k in fields}
    kw["phi_iq"] = tuple(kw["phi_iq"])
    return DpConfig(**kw)


def gaps(got: dict, want: dict) -> dict:
    """Frame 0's gaps: var_est relative, MI (bits) and SER absolute, worst over runs and pols."""
    return {
        "frame0_var_est_rel": float(((got["var_est"] - want["var_est"]).abs()
                                     / want["var_est"].abs()).max()),
        "frame0_mi_abs": float((got["mi"] - want["mi"]).abs().max()),
        "frame0_ser_abs": float((got["ser"] - want["ser"]).abs().max()),
    }


class Cell:
    def __init__(self, cfg: dict, mix: dict, limits: dict, seed: int, device: str):
        self.cfg, self.mix, self.limits, self.seed, self.device = cfg, mix, limits, seed, device
        self.done: list = []  # (seed, frame-0 rows, final w) of each finished experiment

    def setup(self) -> None:
        from vae_equalizer_tpu_torch.train import train_vae_dp, train_vae_flex_dp

        self.pcfg = program_config(self.cfg)
        self.entry = train_vae_dp if self.cfg["loss_type"] == "VAE" else train_vae_flex_dp
        t = time.perf_counter()
        self.call(experiment_seed(self.seed, 0))
        self._sync()
        print(f"setup: warm-up experiment (kernels loaded or built) {time.perf_counter() - t:.3f} s",
              file=sys.stderr)

    def _sync(self) -> None:
        if self.device == "cuda":
            torch.cuda.synchronize()

    def call(self, seed: int) -> dict:
        return self.entry(self.pcfg, seed, device=self.device, runs=self.mix["runs"],
                          use_pallas=self.mix["use_pallas"], compiled=self.mix["compiled"])

    def symbols(self) -> int:
        """Symbols one experiment trains: runs x frames x symbols a frame."""
        bl = self.cfg["batch_len"]
        return self.mix["runs"] * self.cfg["num_frames"] * (self.cfg["n_frame_max"] // bl * bl)

    def _experiment(self, k: int) -> None:
        s = experiment_seed(self.seed, k)
        with torch.profiler.record_function("bench.experiment"):
            res = self.call(s)
        self._sync()
        self.done.append((s, {key: res[key][..., 0] for key in ("ser", "mi", "var_est")},
                          res["params"]["w"]))

    def window(self, seconds: float, tracer) -> dict:
        k, walls = 0, []
        tracer.rest_begin()
        t0 = t_prev = time.perf_counter()
        while t_prev - t0 < seconds:  # experiments begun while time remains
            k += 1
            self._experiment(k)
            t_now = time.perf_counter()
            walls.append(t_now - t_prev)
            t_prev = t_now
        tracer.rest_end()
        wall = t_prev - t0
        print(f"window: {k} experiments in {wall:.3f} s, each {min(walls):.4f} / "
              f"{float(np.median(walls)):.4f} / {max(walls):.4f} s (min / median / max)",
              file=sys.stderr)
        if tracer.on:  # one more experiment, under the profiler
            tracer.start()
            self._experiment(k + 1)
            tracer.stop(units=self.cfg["num_frames"])
        failed = sum(not all(np.all(np.isfinite(v)) for v in rows.values()) for _, rows, _ in self.done)
        return {"attempted": len(self.done), "failed": failed,
                "metrics": {"symbols_per_s": k * self.symbols() / wall}}

    def check(self) -> list[dict]:
        """Follow a sample of the finished experiments with the reference;
        each number is the worst over the sample."""
        rng = np.random.default_rng([self.seed % 2**64, 7])
        n = min(self.mix["check_experiments"], len(self.done))
        picks = sorted(rng.choice(len(self.done), size=n, replace=False).tolist())
        worst: dict = {}
        for i in picks:
            s, rows, w = self.done[i]
            for name, v in self.readings(s, rows, w).items():
                worst[name] = max(worst.get(name, 0.0), v if math.isfinite(v) else math.inf)
        return [{"name": name, "value": worst[name], "limit": self.limits["limits"][name]}
                for name in self.limits["limits"]]

    def readings(self, seed: int, rows: dict, w: torch.Tensor) -> dict:
        """The numbers of one experiment: frame 0 against the reference's
        frame 0 of the same draws, and the final butterflies' SER on a fresh
        frame (mean of the pols, worst run)."""
        want = ref.frame0(self.cfg, seed, self.mix["runs"], self.device)
        got = {k: torch.as_tensor(np.asarray(v), device=want["ser"].device) for k, v in rows.items()}
        out = gaps(got, want)
        final = ref.eval_params(self.cfg, w.detach().float(), seed ^ 0x5EED,
                                self.cfg["num_frames"] - 1)
        out["final_ser"] = float(final.mean(-1).max())
        return out
