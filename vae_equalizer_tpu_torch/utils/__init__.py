"""Configurations and weight conversion."""

from .config import AwgnVaeLeConfig, AwgnVaeNnConfig, DpConfig

__all__ = ["AwgnVaeLeConfig", "AwgnVaeNnConfig", "DpConfig"]
