"""Device time a frame of the operations launched under the program's ``dp.train`` span
(kernel B's launch and its wrapper's work, ``train/dp.py`` -> ``ops/frame_kernel.py``), over
the experiment's frames (``spans.device_ms_per_unit``)."""

from benchmark.harness import spans


def read(t, cell):
    return spans.device_ms_per_unit(t, "dp.train")
