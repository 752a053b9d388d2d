"""Frozen operation and byte counts of the kernels that the sweep cells time:
kernel B with the SNR axis batched into its runs (a demapper variance per
run) and kernel K, one launch a frame each for all runs.

Copied from ``chip_smoke.py`` (``_dp_step_flops`` through ``counts.py``;
``_eval_flops``; the bytes as ``_nbytes`` counts a launch's arguments and
results, each read or written once), so that they stay fixed while the
program changes. ``benchmark/tests/kinds/sweep.py: launches`` holds them
equal to the originals at the cell's shapes.
"""

from __future__ import annotations

from . import counts

# the sync searches' correlation window that kernel K reads (ops/eval_kernel.py: SYNC_CORR_LEN)
CORR_LEN = 2000
_SHIFTS = 21  # the sync searches' shifts


def runs(cfg: dict, mix: dict) -> int:
    """Runs of a sweep's one runner call: every SNR point's ``iters`` repeats."""
    return len(cfg["snr_grid_db"]) * mix["iters"]


def b_sweep(cfg: dict, mix: dict) -> dict:
    """Kernel B's launch in a sweep cell, one a frame for all runs of the
    call: as ``counts.b_experiment``, with the call's runs."""
    return counts.b_experiment(cfg, {**mix, "runs": runs(cfg, mix)})


def b_launch(shape: dict) -> tuple[float, int]:
    """(operations, bytes) of one kernel B launch of ``shape`` whose demapper
    variance is per run, (R, 2) in place of (2,)."""
    flops, nbytes = counts.b_launch(shape)
    return flops, nbytes + 4 * 2 * (shape["runs"] - 1)


def k_sweep(cfg: dict, mix: dict) -> dict:
    """Kernel K's launch in a sweep cell, one a frame for all runs: runs,
    symbols a frame, levels, the sync window."""
    bl = cfg["batch_len"]
    return dict(runs=runs(cfg, mix), n_sym=cfg["n_frame_max"] // bl * bl,
                n_lev=counts._LEVELS[cfg["mod"]], corr_len=CORR_LEN)


def eval_flops(n_sym: int, n_lev: int, corr_len: int) -> float:
    """Kernel K, one run over a frame of n_sym symbols: the two sync searches
    (2 searches x 8 (comp, b, i) x 21 shifts x corr_len multiply-adds), then
    per symbol and pol the soft SER (8 variants x 3 operations), the MI (8
    traces x 12; the prior 3), the rescale (2), the constellation SER's 4
    (n_lev - 1) level comparisons and 8 variants x 4, and the magnitudes (8)."""
    per_symbol = 8 * 3 + 8 * 12 + 3 + 2 + 4 * (n_lev - 1) + 8 * 4 + 8
    return 2 * 8 * _SHIFTS * corr_len * 2 + 2 * n_sym * per_symbol


def k_launch(shape: dict) -> tuple[float, int]:
    """(operations, bytes) of one kernel K launch of ``shape``: it reads
    kernel B's out, dec, mm, s1 (R, 2, 2, n_sym) and eq (R, 2, n_sym)
    streams and tx (R, 2, 2, n_sym), 4 bytes each, and writes ser_const,
    ser_soft, mi, shift (R, 2) and r (R,), 4 bytes each."""
    s = shape
    streams = s["runs"] * s["n_sym"] * (4 * 4 + 2 + 4)
    results = s["runs"] * (4 * 2 + 1)
    return s["runs"] * eval_flops(s["n_sym"], s["n_lev"], s["corr_len"]), 4 * (streams + results)


def share(t, kernel: str, wrapper: str, work: tuple[float, int]) -> float | None:
    """A kernel's share (%) of its roofline: the bound of one launch of
    ``work`` (operations, bytes) over the kernel's mean device time a launch
    in the trace (events named with ``kernel``). None unless the trace holds
    every launch the program counted on ``wrapper`` (a compiled runner's
    warm-up launch, which the program does not count, may add one)."""
    ev = t.matching(kernel)
    n = t.counters.get("launches", {}).get(wrapper, 0)
    if not ev or not n <= len(ev) <= n + 1:
        return None
    mean_ms = sum(e - s for _, s, e in ev) / len(ev) * 1e-3
    return 100.0 * counts.bound(*work)["bound_ms"] / mean_ms
