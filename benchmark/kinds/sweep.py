"""Traffic kind ``sweep``: whole SNR-curve sweeps of the DP VAE through the
program's sweep engine (``parallel/sweep.py: run_sweep``), back to back,
each with its own seed.

The configuration's ``snr_grid_db`` and ``lr`` are the grid, as the sweep
driver (``drivers/eval_run_dp.py``) builds its axes from its command line.
The mix's parameters: ``iters`` (repeats a grid point), ``batch_snr_axis``,
``use_pallas``, ``compiled`` and ``save_params`` (the sweep's options, as
the driver passes them), ``check_sweeps`` (how many finished sweeps the
output check follows). With the SNR axis batched, a sweep is one runner call
of points x iters runs: one kernel B and one kernel K launch a frame for all
of them. Sweep k's seed is drawn from the run's ``--seed`` and k, so one
seed gives one sequence of sweeps; each sweep writes its JSONL records and
parameter files into a directory of its own under the run's scratch
directory, which the check reads and then removes.

Set-up builds the configuration and runs one warm-up sweep of the same
shapes and options. The window starts sweeps while ``seconds`` have not run
out and closes at the end of the last one begun: ``symbols_per_s`` is every
symbol trained (points x iters x frames x symbols a frame) over the whole
window. A traced run profiles one more sweep once the window has closed.

The check, once the window has closed, follows ``check_sweeps`` of the
finished sweeps, drawn from the seed, with the plain reference
(``benchmark/reference/dp_vae_sweep.py``), reading every number from the
sweep's own records and parameter files, so that a record cut from the
wrong runs fails: frame 0 of every point against the reference's frame 0 of
the same runs (the gaps of its SER, MI and noise variance estimate), each
record's demapper variance against the point's, and each point's final
butterflies equalizing a fresh frame at its SNR (their soft SER less the
point's ceiling, ``ceilings`` in the cell's limits file).
"""

from __future__ import annotations

import json
import math
import pathlib
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark.kinds.experiment import experiment_seed, gaps, program_config
from benchmark.reference import dp_vae_sweep as ref


def axes(cfg: dict) -> dict:
    """The grid's axes as the sweep driver builds them from its command line:
    the SNR grid and the single lr, every other axis at its one value."""
    return dict(snr_db=[float(s) for s in cfg["snr_grid_db"]], symb_rate=[cfg["symb_rate"]],
                nu=[cfg["nu"]], theta_diff=[cfg["theta_diff"]], m_est=[cfg["m_est"]],
                lr=[cfg["lr"]], batch_len=[cfg["batch_len"]], flex_step=[cfg["flex_step"]])


def read_points(done: tuple, n_points: int) -> list[dict]:
    """A finished sweep's records as its JSONL file holds them, in grid
    order, each with the butterflies ``w`` (iters, 2, 4, M) of the parameter
    file that ``run_sweep``'s record of the same point names."""
    _, records, jsonl = done
    files = {tuple(r["coords"]): r["checkpoint"] for r in records}
    recs = sorted(_lines(jsonl), key=lambda r: r["coords"])
    if len(recs) != n_points or len(files) != n_points:
        raise ValueError(f"{jsonl}: {len(recs)} records and {len(files)} parameter files, "
                         f"the grid has {n_points} points")
    for r in recs:
        with np.load(files[tuple(r["coords"])]) as d:
            r["w"] = d["w"]
    return recs


def _lines(jsonl: pathlib.Path) -> list[dict]:
    return [json.loads(line) for line in jsonl.read_text().splitlines() if line.strip()]


class Cell:
    def __init__(self, cfg: dict, mix: dict, limits: dict, seed: int, device: str):
        self.cfg, self.mix, self.limits, self.seed, self.device = cfg, mix, limits, seed, device
        self.done: list = []  # (seed, records, JSONL path) of each finished sweep
        self.snrs = [float(s) for s in cfg["snr_grid_db"]]
        self.scratch = pathlib.Path(tempfile.mkdtemp(prefix="bench_sweep_"))

    def setup(self) -> None:
        from vae_equalizer_tpu_torch.parallel.sweep import run_sweep

        self.run_sweep = run_sweep
        self.base = program_config(self.cfg)
        t = time.perf_counter()
        self.call(experiment_seed(self.seed, 0), "warm-up")
        self._sync()
        print(f"setup: warm-up sweep (kernels loaded or built) {time.perf_counter() - t:.3f} s",
              file=sys.stderr)

    def _sync(self) -> None:
        if self.device == "cuda":
            torch.cuda.synchronize()

    def call(self, seed: int, name: str) -> tuple:
        """One sweep into its own directory: (its records, its JSONL path)."""
        m = self.mix
        records, _, jsonl = self.run_sweep(
            "VAE", self.base, axes(self.cfg), m["iters"], seed, out_dir=self.scratch / name,
            tag=f"VAE_DP_{self.cfg['mod']}", save_params=m["save_params"], compiled=m["compiled"],
            runner_kwargs={"use_pallas": m["use_pallas"]}, batch_snr_axis=m["batch_snr_axis"],
            device=self.device)
        return records, jsonl

    def runs(self) -> int:
        return len(self.snrs) * self.mix["iters"]

    def symbols(self) -> int:
        """Symbols one sweep trains: runs x frames x symbols a frame."""
        bl = self.cfg["batch_len"]
        return self.runs() * self.cfg["num_frames"] * (self.cfg["n_frame_max"] // bl * bl)

    def _sweep(self, k: int) -> None:
        s = experiment_seed(self.seed, k)
        with torch.profiler.record_function("bench.sweep"):
            records, jsonl = self.call(s, f"sweep_{k}")
        self._sync()
        self.done.append((s, records, jsonl))

    def window(self, seconds: float, tracer) -> dict:
        k, walls = 0, []
        tracer.rest_begin()
        t0 = t_prev = time.perf_counter()
        while t_prev - t0 < seconds:  # sweeps begun while time remains
            k += 1
            self._sweep(k)
            t_now = time.perf_counter()
            walls.append(t_now - t_prev)
            t_prev = t_now
        tracer.rest_end()
        wall = t_prev - t0
        print(f"window: {k} sweeps in {wall:.3f} s, each {min(walls):.4f} / "
              f"{float(np.median(walls)):.4f} / {max(walls):.4f} s (min / median / max)",
              file=sys.stderr)
        if tracer.on:  # one more sweep, under the profiler
            tracer.start()
            self._sweep(k + 1)
            tracer.stop(units=self.cfg["num_frames"])
        failed = 0
        for _, _, jsonl in self.done:
            recs = _lines(jsonl)
            failed += len(recs) != len(self.snrs) or not all(
                np.all(np.isfinite(np.asarray(r[key], np.float64)))
                for r in recs for key in ("ser", "mi", "var_est", "var"))
        return {"attempted": len(self.done), "failed": failed,
                "metrics": {"symbols_per_s": k * self.symbols() / wall}}

    def check(self) -> list[dict]:
        """Follow a sample of the finished sweeps with the reference; each
        number is the worst over the sample. The scratch directory goes."""
        rng = np.random.default_rng([self.seed % 2**64, 7])
        n = min(self.mix["check_sweeps"], len(self.done))
        picks = sorted(rng.choice(len(self.done), size=n, replace=False).tolist())
        worst: dict = {}
        try:
            for i in picks:
                s = self.done[i][0]
                for name, v in self.readings(s, read_points(self.done[i], len(self.snrs))).items():
                    v = v if math.isfinite(v) else math.inf
                    worst[name] = max(worst.get(name, -math.inf), v)
        finally:
            shutil.rmtree(self.scratch, ignore_errors=True)
        return [{"name": name, "value": worst[name], "limit": self.limits["limits"][name]}
                for name in self.limits["limits"]]

    def readings(self, seed: int, recs: list[dict]) -> dict:
        """The numbers of one sweep, from its records ``recs`` (grid order):
        frame 0 of every point against the reference's frame 0 of the same
        runs, each record's variance against its point's, and each point's
        final butterflies' soft SER (mean of the pols, worst run) less the
        point's ceiling."""
        iters = self.mix["iters"]
        want = ref.frame0(self.cfg, ref.group_seed(seed, 0), self.snrs, iters, self.device)
        dev = want["ser"].device
        col = lambda key: torch.as_tensor(  # noqa: E731
            np.concatenate([np.asarray(r[key], np.float32)[..., 0] for r in recs]), device=dev)
        out = gaps({key: col(key) for key in ("ser", "mi", "var_est")}, want)
        var = torch.as_tensor(np.stack([np.asarray(r["var"], np.float32) for r in recs]))
        out["var_rel"] = float(((var - want["var"]).abs() / want["var"]).max())
        if "final_ser_excess" in self.limits["limits"]:
            ceilings = [self.limits["ceilings"][f"{snr:g}"] for snr in self.snrs]
            out["final_ser_excess"] = max(
                f - c for f, c in zip(self.final_sers(seed, recs, dev), ceilings))
        return out

    def final_sers(self, seed: int, recs: list[dict], device) -> list[float]:
        """Each point's final butterflies' soft SER on a fresh frame at its
        SNR: the mean of the pols, the worst run."""
        out = []
        for j, (snr, r) in enumerate(zip(self.snrs, recs)):
            w = torch.as_tensor(r["w"], dtype=torch.float32, device=device)
            out.append(float(ref.final_ser(self.cfg, w, (seed ^ 0x5EED) + j, snr).mean(-1).max()))
        return out
