"""Configurations, weight conversion (``convert``) and results IO (``io``)."""

from .config import AwgnCmaConfig, AwgnVaeLeConfig, AwgnVaeNnConfig, DpConfig, LmmseDfeConfig

__all__ = ["AwgnCmaConfig", "AwgnVaeLeConfig", "AwgnVaeNnConfig", "DpConfig", "LmmseDfeConfig"]
