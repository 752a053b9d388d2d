"""Device time a frame of the operations launched under the program's ``dp.channel`` span
(the draws and the channel physics at each run's SNR, ``train/dp.py`` ->
``channels/optical_dp.py``), over the traced sweep's frames (``spans.device_ms_per_unit``)."""

from benchmark.harness import spans


def read(t, cell):
    return spans.device_ms_per_unit(t, "dp.channel")
