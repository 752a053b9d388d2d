"""Kernel B's share of its roofline in the sweep cells: one launch a frame
for every run of the sweep's call, each run at its own point's SNR, at the
cell's shapes (``counts_sweep.b_sweep``)."""

from benchmark.harness import counts_sweep


def read(t, cell):
    return counts_sweep.share(t, "vae_dp_frame_kernel", "vae_dp_frame_train",
                              counts_sweep.b_launch(counts_sweep.b_sweep(cell.config, cell.mix)))
