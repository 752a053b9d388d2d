"""Configurations and weight conversion."""

from .config import DpConfig

__all__ = ["DpConfig"]
