"""The whole training step's share of the card's float32 peak in the sweep
cells: kernel B's launches over the untraced window, each counted at the
cell's shapes (``counts_sweep.b_sweep``)."""

from benchmark.harness import counts_sweep, readers


def read(t, cell):
    flops, _ = counts_sweep.b_launch(counts_sweep.b_sweep(cell.config, cell.mix))
    return readers.mfu(cell, "vae_dp_frame_train", flops)
