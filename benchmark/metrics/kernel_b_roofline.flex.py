"""Kernel B's share of its roofline in the VAEflex cells: one launch a frame
for all runs, 990 overlapping windows of 100 symbols every 10
(``counts.b_experiment``, which counts VAEflex's windows)."""

from benchmark.harness import counts, readers


def read(t, cell):
    return readers.roofline(t, "vae_dp_frame_kernel", "vae_dp_frame_train",
                            counts.b_experiment(cell.config, cell.mix))
