"""Mean host length a block of the program's ``streaming.adapt`` span: the streaming
receiver's adaptation (``models/streaming.py``; ``spans.mean_host_ms``)."""

from benchmark.harness import spans


def read(t, cell):
    return spans.mean_host_ms(t, "streaming.adapt")
