"""Kernel B's share of its roofline in the stream cells: one R = 1 launch a
block, at the cell's shapes (``counts.b_stream``)."""

from benchmark.harness import counts, readers


def read(t, cell):
    return readers.roofline(t, "vae_dp_frame_kernel", "vae_dp_frame_train",
                            counts.b_stream(cell.config, cell.mix))
