"""VAE-LE 2x2 MIMO butterfly equalizer + PCS soft demapper (DP).

Port of the DP half of ``vae_equalizer_tpu/models/vae_le.py``. The butterfly
is the reference twoXtwoFIR (shared_funcs.py:490-527): a stride-``sps``
cross-correlation with 4 -> 2 channels, where the I output consumes
(x_I^x, x_I^y, -x_Q^x, -x_Q^y) and the Q output (x_Q^x, x_Q^y, x_I^x, x_I^y),
padding M//2. Here it is an ``unfold`` (im2col) plus one ``einsum``, which
takes any leading batch dims (the runs axis) with per-run weights and stays
in full float32 (no cuDNN, so no TF32).

The demapper is softmin((out - a)^2 / (2 var_pol) + nu_sc a^2) over the
levels, with the PCS correction term (Cho & Winzer).
"""

from __future__ import annotations

import torch
from torch import nn

from .cma import dirac_taps_dp

__all__ = ["VaeLeDp", "butterfly_init", "butterfly_apply", "soft_demap_dp", "vae_le_dp_forward"]


def butterfly_init(m_est: int, device="cpu") -> torch.Tensor:
    """Dirac-initialized butterfly kernel (2, 4, M): w[o, o, M//2] = 1."""
    w = torch.zeros((2, 4, m_est), dtype=torch.float32, device=device)
    w[0, 0, m_est // 2] = 1.0
    w[1, 1, m_est // 2] = 1.0
    return w


def _arrangements(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 2 pol, 2 I/Q, L) -> the signed I and Q input arrangements (..., 4, L)."""
    x_i = torch.cat([x[..., :, 0, :], -x[..., :, 1, :]], dim=-2)
    x_q = torch.cat([x[..., :, 1, :], x[..., :, 0, :]], dim=-2)
    return x_i, x_q


def _im2col(x: torch.Tensor, m: int, stride: int) -> torch.Tensor:
    """(..., C, L) zero-padded by m//2 -> windows (..., C, N, m)."""
    pad = m // 2
    return torch.nn.functional.pad(x, (pad, pad)).unfold(-1, m, stride)


def butterfly_apply(w: torch.Tensor, x: torch.Tensor, sps: int) -> torch.Tensor:
    """Complex 2x2 butterfly FIR. w (..., 2, 4, M), x (..., 2, 2, L) -> (..., 2, 2, N)."""
    m = w.shape[-1]
    x_i, x_q = _arrangements(x)
    out_i = torch.einsum("...oik,...ink->...on", w, _im2col(x_i, m, sps))
    out_q = torch.einsum("...oik,...ink->...on", w, _im2col(x_q, m, sps))
    return torch.stack([out_i, out_q], dim=-2)


def soft_demap_dp(out: torch.Tensor, amps: torch.Tensor, var: torch.Tensor,
                  nu_sc: float) -> torch.Tensor:
    """PCS-aware Gaussian soft demapper.

    out (..., 2 pol, 2, N), var (..., 2) -> q (..., 2 pol, 2*num_lev, N);
    q[..., :n, :] are I-level posteriors, q[..., n:, :] Q-level posteriors.
    """
    d = out[..., None, :] - amps[:, None]
    metric = d * d / (2.0 * var[..., :, None, None, None]) + nu_sc * (amps * amps)[:, None]
    q = torch.softmax(-metric, dim=-2)
    return q.reshape(q.shape[:-3] + (2 * amps.shape[0], q.shape[-1]))


def vae_le_dp_forward(w: torch.Tensor, x: torch.Tensor, amps: torch.Tensor, var: torch.Tensor,
                      nu_sc: float, sps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Butterfly equalizer + soft demapper. Returns (q (..., 2, 2n, N), out (..., 2, 2, N))."""
    out = butterfly_apply(w, x, sps)
    return soft_demap_dp(out, amps, var, nu_sc), out


class VaeLeDp(nn.Module):
    """The DP VAE-LE parameters: butterfly ``w`` (R?, 2, 4, M) and channel
    estimate ``h`` (R?, 2, 2, 2, M), Dirac-initialized, optionally with a
    leading runs axis."""

    def __init__(self, m_est: int, runs: int | None = None, device="cpu"):
        super().__init__()
        w, h = butterfly_init(m_est, device), dirac_taps_dp(m_est, device)
        if runs is not None:
            w = w.expand((runs,) + w.shape).clone()
            h = h.expand((runs,) + h.shape).clone()
        self.w = nn.Parameter(w)
        self.h = nn.Parameter(h)

    def forward(self, x: torch.Tensor, amps: torch.Tensor, var: torch.Tensor, nu_sc: float,
                sps: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
        return vae_le_dp_forward(self.w, x, amps, var, nu_sc, sps)
