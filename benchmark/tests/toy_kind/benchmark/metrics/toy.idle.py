"""The card's idle share of the traced window in the toy cell."""

from benchmark.harness.readers import idle as read  # noqa: F401
