"""Kernel B's share of its roofline in the experiment cells: one launch a
frame for all runs, at the cell's shapes (``counts.b_experiment``)."""

from benchmark.harness import counts, readers


def read(t, cell):
    return readers.roofline(t, "vae_dp_frame_kernel", "vae_dp_frame_train",
                            counts.b_experiment(cell.config, cell.mix))
