"""Viterbi-Viterbi carrier-phase estimation (CPE), dual and single polarization.

Port of ``vae_equalizer_tpu/metrics/cpe.py: cpe_dp, cpe_siso`` with any
leading batch dims. Raise each pol's signal to the 4th power to strip the
square-QAM modulation, moving-average it ('same', zero padded, M_MA = 501),
phi = atan2(Im, -Re) / 4, for DP remove the +-pi/2 jumps with a cumulative
sum of jump indicators (the reference's unwrap loop, shared_funcs.py:140-186;
the SISO reference does not unwrap, func_CMA_MQAM_shaping.py:170-196), and
de-rotate. The moving average is ``avg_pool1d`` with zero padding counted:
a plain float32 window sum (a cuDNN convolution would run in TF32 by
default on the card).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["M_MA", "cpe_dp", "cpe_siso"]

M_MA = 501  # moving-average filter length


def _pow4(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(a + jb)^4 in real arithmetic."""
    a2, b2 = a * a, b * b
    re = a2 * a2 - 6.0 * a2 * b2 + b2 * b2
    im = 4.0 * (a2 * a * b - a * b2 * b)
    return re, im


def _moving_average(x: torch.Tensor, m: int = M_MA) -> torch.Tensor:
    """'same' moving average along the last axis, zero padded, kernel 1/m."""
    flat = x.reshape(-1, 1, x.shape[-1])
    return F.avg_pool1d(flat, m, stride=1, padding=m // 2).reshape(x.shape)


def _unwrap_quarter(phi: torch.Tensor) -> torch.Tensor:
    """Remove +-pi/2 jumps along the last axis: cumulative correction."""
    diff = phi[..., 1:] - phi[..., :-1]
    jumps = (diff > math.pi / 4).to(phi.dtype) - (diff < -math.pi / 4).to(phi.dtype)
    corr = F.pad(torch.cumsum(jumps, dim=-1), (1, 0))
    return phi - (math.pi / 2) * corr


def _derotate(a: torch.Tensor, b: torch.Tensor, phi: torch.Tensor):
    c, s = torch.cos(phi), torch.sin(phi)
    return a * c - b * s, b * c + a * s


def cpe_dp(y: torch.Tensor) -> torch.Tensor:
    """DP Viterbi-Viterbi CPE with pi/2 unwrapping. y (..., 2, 2, N) -> same shape."""
    a, b = y[..., 0, :], y[..., 1, :]  # (..., pol, N)
    ma = _moving_average(torch.stack(_pow4(a, b), dim=-2))  # (..., pol, re/im, N)
    phi = _unwrap_quarter(torch.atan2(ma[..., 1, :], -ma[..., 0, :]) / 4)
    return torch.stack(_derotate(a, b, phi), dim=-2)


def cpe_siso(y: torch.Tensor) -> torch.Tensor:
    """SISO Viterbi-Viterbi CPE, no unwrapping. y (..., 2, N) -> same shape."""
    a, b = y[..., 0, :], y[..., 1, :]
    ma = _moving_average(torch.stack(_pow4(a, b), dim=-2))  # (..., re/im, N)
    phi = torch.atan2(ma[..., 1, :], -ma[..., 0, :]) / 4
    return torch.stack(_derotate(a, b, phi), dim=-2)
