"""Kernel K's share of its roofline in the 128-run experiment cells: one launch a frame
evaluating every run, a cluster of 8 blocks a run, past 8 waves of the clusters the card fits
(``counts_eval.k_experiment``)."""

from benchmark.harness import counts_eval, counts_sweep


def read(t, cell):
    work = counts_sweep.k_launch(counts_eval.k_experiment(cell.config, cell.mix))
    return counts_sweep.share(t, "vae_dp_eval_kernel", "vae_dp_frame_eval", work)
