"""Kernel B's share of its roofline in the 128-run experiment cells: one launch a frame, a
block a run on 128 of the card's 132 SMs (``counts.b_experiment``)."""

from benchmark.harness import counts, readers


def read(t, cell):
    return readers.roofline(t, "vae_dp_frame_kernel", "vae_dp_frame_train",
                            counts.b_experiment(cell.config, cell.mix))
