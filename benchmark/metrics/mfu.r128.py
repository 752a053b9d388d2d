"""The whole training step's share of the card's float32 peak in the 128-run experiment
cells: kernel B's launches over the untraced window, each counted at the cell's shapes
(``counts.b_experiment``, 128 runs)."""

from benchmark.harness import counts, readers


def read(t, cell):
    flops, _ = counts.b_launch(counts.b_experiment(cell.config, cell.mix))
    return readers.mfu(cell, "vae_dp_frame_train", flops)
