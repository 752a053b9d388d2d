"""Configurations and weight conversion."""

from .config import AwgnVaeLeConfig, DpConfig

__all__ = ["AwgnVaeLeConfig", "DpConfig"]
