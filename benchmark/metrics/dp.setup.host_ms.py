"""Host length of the program's ``dp.setup`` span in the traced experiment: what a
``train_vae_dp`` call does before its frame loop (``train/dp.py``; ``spans.mean_host_ms``)."""

from benchmark.harness import spans


def read(t, cell):
    return spans.mean_host_ms(t, "dp.setup")
