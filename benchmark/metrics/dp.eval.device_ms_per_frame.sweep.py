"""Device time a frame of the operations launched under the program's ``dp.eval`` span
(kernel K for every run, then the packed metrics, ``train/dp.py``), over the traced
sweep's frames (``spans.device_ms_per_unit``)."""

from benchmark.harness import spans


def read(t, cell):
    return spans.device_ms_per_unit(t, "dp.eval")
