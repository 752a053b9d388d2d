"""Device time a frame of the operations launched under the program's ``dp.train`` span in
the VAEflex cells (kernel B's launch of 990 windows and its wrapper's work; the copy of frame
0's losses is ``dp.losses``'), over the experiment's frames (``spans.device_ms_per_unit``)."""

from benchmark.harness import spans


def read(t, cell):
    return spans.device_ms_per_unit(t, "dp.train")
