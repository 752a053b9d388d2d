"""Square M-QAM constellations with probabilistic constellation shaping (PCS).

Port of ``vae_equalizer_tpu/core/constellation.py``. Setup-time NumPy in
float64, cast to float32 at the end, exactly as the JAX package does, so both
packages start from bit-identical constants. The draw of PCS levels is split
into a deterministic inverse CDF (``levels_from_uniform``, testable against
JAX on given uniforms) and the draw of the uniforms from a ``torch.Generator``
(``sample_levels``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "Constellation",
    "qam_points",
    "mb_prior",
    "make_constellation",
    "demapper_noise_var",
    "levels_from_uniform",
    "sample_levels",
]

_MOD_SIZES = {"4-QAM": 2, "16-QAM": 4, "64-QAM": 8, "256-QAM": 16}


def qam_points(mod: str) -> np.ndarray:
    """Unit-power square QAM constellation, real-major ordering (complex64)."""
    m = _MOD_SIZES[mod]
    levels = np.arange(-(m - 1), m, 2, dtype=np.float64)
    c = np.repeat(levels, m) + 1j * np.tile(levels, m)
    c = c / np.sqrt(np.mean(np.abs(c) ** 2))
    return c.astype(np.complex64)


def mb_prior(amps: np.ndarray, nu: float) -> np.ndarray:
    """Maxwell-Boltzmann pmf ``P_i ∝ exp(-nu (a_i / min|a|)^2)`` (float64)."""
    sc = np.min(np.abs(amps))
    P = np.exp(-nu * np.abs(amps / sc) ** 2)
    return (P / np.sum(P)).astype(np.float64)


@dataclasses.dataclass(frozen=True)
class Constellation:
    """Static per-experiment constellation/PCS description.

    ``amps`` (num_lev,) float32 levels ascending; ``P`` (num_lev,) float64
    pmf; ``nu_sc = nu / min|amps|^2``; ``pow_mean = 2 E_P[a^2]``.
    """

    mod: str
    points: np.ndarray
    amps: np.ndarray
    P: np.ndarray
    nu: float
    nu_sc: float
    pow_mean: float
    amp_mean: float
    entropy: float

    @property
    def num_lev(self) -> int:
        return self.amps.shape[0]


def make_constellation(mod: str, nu: float = 0.0) -> Constellation:
    num_lev = _MOD_SIZES[mod]
    levels = np.arange(-(num_lev - 1), num_lev, 2, dtype=np.float64)
    amps64 = levels / np.sqrt(np.mean(np.abs(levels[:, None] + 1j * levels[None, :]) ** 2))
    P = mb_prior(amps64, nu)
    sc = float(np.min(np.abs(amps64)))
    return Constellation(
        mod=mod,
        points=qam_points(mod),
        amps=amps64.astype(np.float32),
        P=P,
        nu=float(nu),
        nu_sc=float(nu / sc**2),
        pow_mean=float(2.0 * np.sum(P * amps64**2)),
        amp_mean=float(np.sum(P * np.abs(amps64))),
        entropy=float(-2.0 * np.sum(P * np.log2(P))),
    )


def demapper_noise_var(const: Constellation, snr_db: float) -> float:
    """Per-component demapper noise variance ``pow_mean / 10^(SNR/10) / 2``."""
    return const.pow_mean / 10 ** (snr_db / 10) / 2


def levels_from_uniform(u: torch.Tensor, amps: np.ndarray, P: np.ndarray) -> torch.Tensor:
    """Inverse CDF of the PCS pmf at given uniforms ``u`` (any shape).

    Builds the level as ``amps[0]`` plus one step per crossed CDF edge, in
    float32, like the JAX ``sample_levels`` (constellation.py:161-163) — so
    the same uniforms give bit-identical levels. ``P`` (n,) is shared by all
    of ``u``; a per-run pmf (R, n) applies row r to ``u[r]`` (the sweep's nu
    axis batched as runs; JAX's ``generate(..., P_r)``).
    """
    amps32 = np.asarray(amps, np.float32)
    cum = np.cumsum(np.asarray(P, dtype=np.float32), axis=-1)
    steps = np.diff(amps32)
    a = torch.full(u.shape, float(amps32[0]), dtype=torch.float32, device=u.device)
    zero = torch.zeros((), dtype=torch.float32, device=u.device)
    if cum.ndim > 1:  # per run: edges (R, 1, ..., 1) against u (R, ...)
        cum = _edges_on(cum, u.device).reshape(cum.shape[:1] + (1,) * (u.dim() - 1) + cum.shape[1:])
    for lev in range(1, amps32.shape[0]):
        # filled in on the device (no host-to-device copy, which a CUDA graph
        # could not capture): the same float32 step
        step = torch.full((), float(steps[lev - 1]), dtype=torch.float32, device=u.device)
        edge = float(cum[lev - 1]) if isinstance(cum, np.ndarray) else cum[..., lev - 1]
        a = a + torch.where(u >= edge, step, zero)
    return a


_EDGES: dict = {}


def _edges_on(cum: np.ndarray, device) -> torch.Tensor:
    """The per-run CDF edges (R, n) float32 on ``device``, copied there once
    per device and pmf: the draws of every later frame reuse the copy, so a
    frame captured in a CUDA graph holds no host-to-device copy."""
    key = (str(torch.device(device)), cum.shape, cum.tobytes())
    if key not in _EDGES:
        _EDGES[key] = torch.from_numpy(cum).to(device)
    return _EDGES[key]


def sample_levels(gen: torch.Generator, amps: np.ndarray, P: np.ndarray, shape,
                  device=None) -> torch.Tensor:
    """Draw amplitude levels i.i.d. from the PCS pmf with ``gen``; ``P`` (n,),
    or (R, n) per run over the leading axis of ``shape``."""
    device = gen.device if device is None else device
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return levels_from_uniform(u, amps, P)
