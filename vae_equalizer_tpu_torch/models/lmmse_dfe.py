"""Closed-form LMMSE (Wiener) equalizer and decision-feedback equalizer.

Port of ``vae_equalizer_tpu/models/lmmse_dfe.py`` (the reference's
AWGN_channel/DFE_MQAM_shaping.py:154-241). The filter design is setup-time
NumPy linear algebra in complex128, copied from the JAX package; it builds
the normal equations with the reference's plain transpose H @ H.T (not the
conjugate), reproduced as is. ``complex_fir`` and ``nearest_neighbor`` take
any leading batch dims; ``dfe_equalize`` runs kernel J
(``ops/dfe_kernel.py``) on a CUDA tensor and its plain version on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.dfe_kernel import dfe_decide
from .vae_nn import no_tf32

__all__ = [
    "compute_lmmse",
    "compute_feedforward",
    "compute_feedback",
    "complex_fir",
    "nearest_neighbor",
    "dfe_equalize",
]


def compute_lmmse(channel: np.ndarray, snr_db: float, order: int, n1: int) -> np.ndarray:
    """MMSE filter taps from known channel taps. Returns (order,) complex."""
    sigma_w = 1 / 2 / 10 ** (snr_db / 10)
    L = len(channel) - 1
    H = np.zeros((order, order + L), np.complex128)
    flipped = channel[::-1]
    for i in range(order):
        H[i, i : i + L + 1] = flipped
    w = np.linalg.inv(sigma_w * np.eye(order) + H @ H.T) @ H[:, -(n1 + 1)]
    return w[::-1].astype(np.complex64)


def compute_feedforward(channel: np.ndarray, snr_db: float, order: int) -> np.ndarray:
    """Causal MMSE feedforward section of the DFE. Returns (order,) complex."""
    sigma_w = 1 / 2 / 10 ** (snr_db / 10)
    L = len(channel) - 1
    H = np.zeros((order, order), np.complex128)
    for i in range(order - L):
        H[i, i : i + L + 1] = channel
    for i in range(L):
        H[order - L + i, order - L + i :] = channel[: L - i]
    rhs = np.concatenate([np.zeros(order - L - 1, np.complex128), channel[::-1]])
    w = np.linalg.inv(sigma_w * np.eye(order) + H @ H.T) @ rhs
    return w.astype(np.complex64)


def compute_feedback(channel: np.ndarray, feedforward: np.ndarray) -> np.ndarray:
    """Feedback taps from the feedforward taps and the channel. (L,) complex."""
    L = len(channel) - 1
    fb = np.zeros(L, np.complex128)
    for k in range(L):
        fb[k] = -np.dot(feedforward[-(L - k) :], channel[k + 1 :][::-1])
    return fb.astype(np.complex64)


def complex_fir(rx: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Complex FIR, true convolution with zero padding K//2 on both sides.

    rx (..., 2, L) planes; h (2, K), or one filter per leading index
    (..., 2, K). Returns (..., 2, L - K + 1 + 2 (K//2)) (compl_conv,
    DFE_MQAM_shaping.py:236-241): one grouped float32 convolution (each
    signal its own group, cuDNN's TF32 off on the card) with the taps
    flipped, re = rx_re * h_re - rx_im * h_im, im = rx_re * h_im + rx_im * h_re.
    """
    batch, k = rx.shape[:-2], h.shape[-1]
    x = rx.reshape(1, -1, rx.shape[-1])  # (1, 2 B, L)
    n_sig = x.shape[1] // 2
    hf = torch.broadcast_to(h, batch + h.shape[-2:]).reshape(n_sig, 2, k).flip(-1)
    hr, hi = hf[:, 0], hf[:, 1]
    weight = torch.stack([torch.stack([hr, -hi], dim=1), torch.stack([hi, hr], dim=1)], dim=1)
    with no_tf32():
        y = F.conv1d(x, weight.reshape(2 * n_sig, 2, k), padding=k // 2, groups=n_sig)
    return y.reshape(batch + (2, y.shape[-1]))


def nearest_neighbor(sym: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Hard decision to the nearest constellation point, first index on ties.

    sym (..., 2, N) planes; points (2, n_points). Returns (..., N) int32.
    """
    d_re = sym[..., 0, None, :] - points[0][:, None]
    d_im = sym[..., 1, None, :] - points[1][:, None]
    return torch.argmin(d_re * d_re + d_im * d_im, dim=-2).to(torch.int32)


def dfe_equalize(ff_out: torch.Tensor, feedback: torch.Tensor, points: torch.Tensor,
                 init_idx: torch.Tensor) -> torch.Tensor:
    """Decision-feedback loop (kernel J on the card, its plain version on the CPU).

    ff_out (..., 2, N) feedforward-filtered signal; feedback (2, K2) or one
    set of taps per leading index (..., 2, K2); points (2, n_points);
    init_idx (..., N) initial hard decisions (the first K2 seed the
    feedback state). Returns (..., N) int32 indices.
    """
    batch, n = ff_out.shape[:-2], ff_out.shape[-1]
    k2 = feedback.shape[-1]
    ff = ff_out.reshape(-1, 2, n).contiguous()
    fb = torch.broadcast_to(feedback, batch + (2, k2)).reshape(ff.shape[0], 2, k2).contiguous()
    init = init_idx.reshape(ff.shape[0], n).to(torch.int32).contiguous()
    return dfe_decide(ff, fb, points.contiguous(), init).reshape(batch + (n,))
