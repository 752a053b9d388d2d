"""Frozen operation and byte counts of the kernels the benchmark reads, and
the card's peaks.

Copied from ``chip_smoke.py`` (``F32_FLOPS``, ``HBM_BYTES``, ``_bound``,
``_elbo_flops``, ``_dp_step_flops``; kernel B's per-step Adam term, 12
operations per parameter of w and h, from its phase 4b): the counts depend
on shapes alone, so they stay fixed here while the program changes.
``benchmark/tests/test_counts.py`` holds them equal to the originals at
every cell's shapes.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at the 700 W limit: float32 outside the
# tensor cores, HBM3 bandwidth
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12


def bound(flops: float, nbytes: int) -> dict:
    """The least time the card could take: the larger of the operations at
    the float32 peak and the bytes at the HBM rate, in ms, and which bounds."""
    t_ops, t_bytes = 1e3 * flops / F32_FLOPS, 1e3 * nbytes / HBM_BYTES
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def elbo_flops(n_samp: int, m: int, n_lev: int, pols: int) -> float:
    """The ELBO from the posteriors and its gradient back to them: the D conv
    of E_q[x] through h, its two adjoints, and ~12 operations a posterior."""
    n_eff = n_samp - (m - 1)
    conv = pols * 2 * n_eff * pols * 2 * ((m + 1) // 2)
    return 2 * 3 * conv + pols * 2 * (n_samp // 2) * n_lev * 12


def dp_step_flops(n_sym: int, m: int, n_lev: int) -> float:
    """One minibatch step of one run (kernels A and B): the butterfly forward
    and gw, the softmin demapper and its VJP, the DP ELBO."""
    return 2 * 2 * 4 * n_sym * 4 * m + 4 * n_sym * n_lev * 12 + elbo_flops(2 * n_sym, m, n_lev, 2)


def b_launch_flops(runs: int, steps: int, bl: int, m: int, n_lev: int) -> float:
    """Kernel B, one launch: ``steps`` minibatch steps of ``runs`` runs, each
    with Adam's ~12 operations per parameter of w (8M) and h (8M)."""
    return runs * steps * (dp_step_flops(bl, m, n_lev) + 12 * 16 * m)


def b_launch_bytes(runs: int, steps: int, bl: int, n_samp: int, m: int, n_lev: int) -> int:
    """Kernel B, one launch, each input byte read once and each output byte
    written once: rx (R, 2, 2, n_samp); w, h and the four Adam moments in
    and out (R x 8M floats each); amps, P (n,) and var (2,); the losses (steps,
    R), var_est (steps, R, 2), out / dec / mm / s1 (steps, R, 2, 2, bl) and
    eq (steps, R, 2, bl) streams; float32 and int32, 4 bytes each."""
    params = 6 * runs * 8 * m
    ins = runs * 4 * n_samp + params + 2 * n_lev + 2
    outs = params + steps * runs * (1 + 2 + 4 * 4 * bl + 2 * bl)
    return 4 * (ins + outs)


_LEVELS = {"4-QAM": 2, "16-QAM": 4, "64-QAM": 8, "256-QAM": 16}  # amplitude levels a dimension


def b_experiment(cfg: dict, mix: dict) -> dict:
    """Kernel B's launch in an experiment cell, one a frame for all runs:
    runs, steps (minibatches back to back for the VAE, a window every
    ``flex_step`` symbols for VAEflex), minibatch, samples a run, M, levels."""
    bl = cfg["batch_len"]
    n_frame = cfg["n_frame_max"] // bl * bl
    steps = n_frame // bl if cfg["loss_type"] == "VAE" else (n_frame - bl) // cfg["flex_step"]
    return dict(runs=mix["runs"], steps=steps, bl=bl, n_samp=cfg["sps"] * n_frame,
                m=cfg["m_est"], n_lev=_LEVELS[cfg["mod"]])


def b_stream(cfg: dict, mix: dict) -> dict:
    """Kernel B's launch in a stream cell, one a block: R = 1, the block's
    minibatches back to back."""
    return dict(runs=1, steps=mix["block_len"] // mix["adapt_batch"], bl=mix["adapt_batch"],
                n_samp=cfg["sps"] * mix["block_len"], m=cfg["m_est"], n_lev=_LEVELS[cfg["mod"]])


def b_launch(shape: dict) -> tuple[float, int]:
    """(operations, bytes) of one kernel B launch of ``shape``."""
    s = shape
    return b_launch_flops(s["runs"], s["steps"], s["bl"], s["m"], s["n_lev"]), b_launch_bytes(**s)
