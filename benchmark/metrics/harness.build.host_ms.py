"""Host length of the program's ``harness.build`` span in the traced experiment: the
frame step's warm-up and its CUDA graph capture (``train/harness.py: StepGraphs.build``;
``spans.mean_host_ms``)."""

from benchmark.harness import spans


def read(t, cell):
    return spans.mean_host_ms(t, "harness.build")
