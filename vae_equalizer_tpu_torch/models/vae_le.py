"""VAE-LE equalizers: the 2x2 MIMO butterfly + PCS soft demapper (DP) and
the complex FIR + normalized soft demapper (SISO, the AWGN experiment).

Port of ``vae_equalizer_tpu/models/vae_le.py``. The butterfly
is the reference twoXtwoFIR (shared_funcs.py:490-527): a stride-``sps``
cross-correlation with 4 -> 2 channels, where the I output consumes
(x_I^x, x_I^y, -x_Q^x, -x_Q^y) and the Q output (x_Q^x, x_Q^y, x_I^x, x_I^y),
padding M//2. Here it is an ``unfold`` (im2col) plus one ``einsum``, which
takes any leading batch dims (the runs axis) with per-run weights and stays
in full float32 (no cuDNN, so no TF32).

The demapper is softmin((out - a)^2 / (2 var_pol) + nu_sc a^2) over the
levels, with the PCS correction term (Cho & Winzer).

The SISO filter is the reference twoFIR (func_VAELE_MQAM_shaping.py:206-231):
2 -> 1 channels applied to (x_I, x_Q) and (x_Q, -x_I), padding (M-1)//2,
stride ``sps``; each output component is normalized to mean magnitude
``amp_mean`` and demapped with softmin((norm - a)^2 / var) (no PCS term, and
var, not 2 var). The same ``unfold`` + ``einsum`` form takes a leading runs
axis with per-run taps, at any sps and M (the JAX runs-batched form was
sps 2 only).
"""

from __future__ import annotations

import torch
from torch import nn

from .cma import dirac_taps_dp

__all__ = [
    "VaeLeDp",
    "butterfly_init",
    "butterfly_apply",
    "siso_fir_init",
    "soft_demap_dp",
    "vae_le_dp_forward",
    "vae_le_siso_forward",
]


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


def _im2col(x: torch.Tensor, m: int, stride: int, pad: int | None = None) -> torch.Tensor:
    """(..., C, L) zero-padded by pad (default m//2) -> windows (..., C, N, m)."""
    pad = m // 2 if pad is None else pad
    return torch.nn.functional.pad(x, (pad, pad)).unfold(-1, m, stride)


def butterfly_apply(w: torch.Tensor, x: torch.Tensor, sps: int,
                    pad: int | None = None) -> torch.Tensor:
    """Complex 2x2 butterfly FIR. w (..., 2, 4, M), x (..., 2, 2, L) -> (..., 2, 2, N).

    x is zero-padded by ``pad`` (default M//2, the frame's same padding) each
    side; a sequence-parallel block that carries its M//2 halo passes 0."""
    m = w.shape[-1]
    x_i, x_q = _arrangements(x)
    out_i = torch.einsum("...oik,...ink->...on", w, _im2col(x_i, m, sps, pad))
    out_q = torch.einsum("...oik,...ink->...on", w, _im2col(x_q, m, sps, pad))
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


def siso_fir_init(m_est: int, device="cpu") -> torch.Tensor:
    """Dirac-initialized SISO kernel (1, 2, M): w[0, 0, M//2] = 1."""
    w = torch.zeros((1, 2, m_est), dtype=torch.float32, device=device)
    w[0, 0, m_est // 2] = 1.0
    return w


def siso_arrangements(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 2 I/Q, L) -> the inputs of the I and Q outputs: (x_I, x_Q) and (x_Q, -x_I)."""
    return x, torch.stack([x[..., 1, :], -x[..., 0, :]], dim=-2)


def siso_windows(x: torch.Tensor, m: int, sps: int) -> torch.Tensor:
    """(..., C, L) zero-padded by (m-1)//2 -> windows (..., C, N, m), a strided view."""
    pad = (m - 1) // 2
    return torch.nn.functional.pad(x, (pad, pad)).unfold(-1, m, sps)


def vae_le_siso_forward(w: torch.Tensor, x: torch.Tensor, amps: torch.Tensor, amp_mean: float,
                        var, sps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex FIR equalizer + normalized soft demapper, SISO.

    w (..., 1, 2, M); x (..., 2, L) -> (q (..., 2*num_lev, N), out (..., 2, N)).
    The demapper input is per-component normalized to mean magnitude
    ``amp_mean``; ``out`` is the unnormalized filter output (as in the
    reference).
    """
    m = w.shape[-1]
    taps = w[..., 0, :, :]  # (..., 2 in, M)
    out = torch.stack([torch.einsum("...ck,...cnk->...n", taps, siso_windows(xa, m, sps))
                       for xa in siso_arrangements(x)], dim=-2)  # (..., 2, N)
    norm = out / out.abs().mean(dim=-1, keepdim=True) * amp_mean
    d = norm[..., None, :] - amps[:, None]  # (..., 2, n, N)
    q = torch.softmax(-(d * d) / var, dim=-2)
    return q.flatten(-3, -2), out
