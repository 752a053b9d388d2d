"""Device time a frame of the operations launched under the program's ``dp.eval`` span in the
VAEflex cells (kernel K on the central 10 symbols of each of B's 990 windows, under the margin
mask, and the packed metrics), over the experiment's frames (``spans.device_ms_per_unit``)."""

from benchmark.harness import spans


def read(t, cell):
    return spans.device_ms_per_unit(t, "dp.eval")
