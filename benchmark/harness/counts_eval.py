"""Kernel K's launch in the experiment cells, one a frame evaluating every
run of the experiment, at the cell's shapes: the sweep cells' frozen count
of K (``counts_sweep.k_launch``), whose operations and bytes depend on the
runs, the symbols a frame, the levels and the sync window alone.
``benchmark/tests/test_counts_eval.py`` holds it equal to
``chip_smoke.py``'s at the 128-run cell's shapes."""

from __future__ import annotations

from . import counts, counts_sweep


def k_experiment(cfg: dict, mix: dict) -> dict:
    """Kernel K's launch in an experiment cell of the DP VAE: runs, symbols
    a frame, levels, the sync window."""
    bl = cfg["batch_len"]
    return dict(runs=mix["runs"], n_sym=cfg["n_frame_max"] // bl * bl,
                n_lev=counts._LEVELS[cfg["mod"]], corr_len=counts_sweep.CORR_LEN)
