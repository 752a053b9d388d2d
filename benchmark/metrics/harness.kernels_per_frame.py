"""Device kernels a frame of the experiment's frame loop (``train/harness.py``) launches (``readers.kernels_per_unit``)."""

from benchmark.harness.readers import kernels_per_unit as read  # noqa: F401
