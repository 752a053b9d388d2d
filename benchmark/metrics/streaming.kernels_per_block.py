"""Device kernels a block of the streaming receiver (``models/streaming.py``) launches (``readers.kernels_per_unit``)."""

from benchmark.harness.readers import kernels_per_unit as read  # noqa: F401
