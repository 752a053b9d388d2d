"""Configurations, weight conversion (``convert``) and results IO (``io``)."""

from .config import AwgnVaeLeConfig, AwgnVaeNnConfig, DpConfig

__all__ = ["AwgnVaeLeConfig", "AwgnVaeNnConfig", "DpConfig"]
