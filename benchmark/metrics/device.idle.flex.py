"""The card's idle share of the traced window in the VAEflex cells (``readers.idle``)."""

from benchmark.harness.readers import idle as read  # noqa: F401
