"""Pulse-shaping filter design (raised-cosine / root-raised-cosine).

Port of ``vae_equalizer_tpu/core/filters.py``: setup-time NumPy, same time
grid ``t = arange(-T*sps/2, T*sps/2, 1/sps)``, same singularity handling,
unit-norm float32 output.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rcfir", "rrcfir"]


def _time_grid(T: int, sps: int) -> np.ndarray:
    return np.arange(-T * sps / 2, T * sps / 2, 1 / sps, dtype=np.float32)


def rcfir(T: int, sps: int, beta: float) -> np.ndarray:
    """Raised-cosine FIR taps, unit L2 norm."""
    t = _time_grid(T, sps)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.sinc(t) * np.cos(np.pi * beta * t) / (1 - (2 * beta * t) ** 2)
    h[np.abs(t) == 1 / 2 / beta] = np.pi / 4 * np.sinc(1 / (2 * beta))
    return (h / np.linalg.norm(h)).astype(np.float32)


def rrcfir(T: int, sps: int, beta: float) -> np.ndarray:
    """Root-raised-cosine FIR taps, unit L2 norm."""
    t = _time_grid(T, sps)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = (np.sin(np.pi * t * (1 - beta)) + 4 * beta * t * np.cos(np.pi * t * (1 + beta))) / (
            np.pi * t * (1 - (4 * beta * t) ** 2)
        )
    h[np.abs(t) == 1 / 4 / beta] = (
        beta
        / np.sqrt(2)
        * ((1 + 2 / np.pi) * np.sin(np.pi / 4 / beta) + (1 - 2 / np.pi) * np.cos(np.pi / 4 / beta))
    )
    h[t == 0] = 1 + beta * (4 / np.pi - 1)
    return (h / np.linalg.norm(h)).astype(np.float32)
