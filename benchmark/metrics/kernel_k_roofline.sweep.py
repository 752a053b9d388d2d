"""Kernel K's share of its roofline in the sweep cells: one launch a frame
evaluating every run of the sweep's call, a cluster of blocks a run, at the
cell's shapes (``counts_sweep.k_sweep``)."""

from benchmark.harness import counts_sweep


def read(t, cell):
    return counts_sweep.share(t, "vae_dp_eval_kernel", "vae_dp_frame_eval",
                              counts_sweep.k_launch(counts_sweep.k_sweep(cell.config, cell.mix)))
