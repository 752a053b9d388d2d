"""Complex baseband as stacked real/imag planes (port of
``vae_equalizer_tpu/core/cplx.py``).

The package's layout: a SISO signal is ``(2, L)`` (I, Q), a DP signal
``(2, 2, L)`` (pol, I/Q, time), SISO taps ``(2, M)`` (re/im, tap) and DP
taps ``(2, 2, 2, M)`` (out-pol, in-pol, re/im, tap). The compute paths stay
in real arithmetic; the channel simulators use complex64 for their FFT pass
and convert at the boundary with ``to_planes`` / ``from_planes``.
"""

from __future__ import annotations

import torch

__all__ = ["cabs2", "cconj", "cmul", "conv_valid", "from_planes", "to_planes"]


def to_planes(z: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """complex (...) -> stacked (..., 2, ...) with the new axis at ``axis``."""
    return torch.stack([z.real, z.imag], dim=axis)


def from_planes(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """stacked -> complex, consuming the size-2 ``axis``."""
    return torch.complex(x.select(axis, 0), x.select(axis, 1))


def cmul(a: torch.Tensor, b: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Complex multiply of stacked-plane tensors along ``axis``."""
    ar, ai = a.select(axis, 0), a.select(axis, 1)
    br, bi = b.select(axis, 0), b.select(axis, 1)
    return torch.stack([ar * br - ai * bi, ar * bi + ai * br], dim=axis)


def cconj(a: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Complex conjugate of a stacked-plane tensor along ``axis``."""
    return torch.stack([a.select(axis, 0), -a.select(axis, 1)], dim=axis)


def cabs2(a: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """|a|^2, removing the size-2 plane axis."""
    return torch.sum(a * a, dim=axis)


def conv_valid(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """'valid' complex convolution of stacked-plane 1-D signals: x (2, Lx),
    h (2, Lh) -> (2, Lx - Lh + 1). A true convolution (the kernel flipped),
    ``np.convolve(mode='valid')`` as the reference's channel simulators use
    it."""
    win = x.unfold(-1, h.shape[-1], 1)  # (2, Lx - Lh + 1, Lh)
    hf = h.flip(-1)
    xr, xi = win[0], win[1]
    return torch.stack([xr @ hf[0] - xi @ hf[1], xr @ hf[1] + xi @ hf[0]])
