"""Device time a frame of the operations launched under the program's ``dp.eval`` span
(sync, SER, MI and the packed metrics, ``train/dp.py`` -> ``metrics/``), over the experiment's
frames (``spans.device_ms_per_unit``)."""

from benchmark.harness import spans


def read(t, cell):
    return spans.device_ms_per_unit(t, "dp.eval")
