"""The whole training step's share of the card's float32 peak in the VAEflex
cells: kernel B's windows over the untraced window (the program's counter
``vae_dp_frame_windows``, ``ops/frame_kernel.py: WINDOWS``), each counted at
the cell's shapes (``counts.b_experiment`` at one step). None where the
program counts no windows, or not every launch's (launches x windows a
frame)."""

from benchmark.harness import counts, readers

WINDOWS = "vae_dp_frame_windows"


def read(t, cell):
    shape = counts.b_experiment(cell.config, cell.mix)
    n = cell.untraced["launches"]
    windows, launches = n.get(WINDOWS, 0), n.get("vae_dp_frame_train", 0)
    if not windows or windows != launches * shape["steps"]:
        return None
    flops, _ = counts.b_launch({**shape, "steps": 1})
    return readers.mfu(cell, WINDOWS, flops)
