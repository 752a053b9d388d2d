"""Mean host length of the program's ``harness.frame`` span: one frame of the frame loop
(``train/harness.py``), the eager step or one graph replay (``spans.mean_host_ms``)."""

from benchmark.harness import spans


def read(t, cell):
    return spans.mean_host_ms(t, "harness.frame")
