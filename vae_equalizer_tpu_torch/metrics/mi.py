"""Mutual information from the demapper's sufficient statistics (DP).

Port of ``vae_equalizer_tpu/metrics/mi.py:
mutual_information_ambiguity_mb_stats`` with any leading batch dims. The
PCS softmin demapper computes q[l] = exp(mm - met_l) / s1 with met_l =
(out - a_l)^2 / (2 var) + nu_sc a_l^2, so (out, mm, s1) reconstruct the
log-posterior at any level; the 8 blind-ambiguity traces each need it at
one tx-derived level. Level selections are direct indexing (the JAX
package's compare-select sweep ``_level_select_vec`` existed because TPU
gathers were slow).

    MI = (1/N) sum_k log2(q_k(x_k) / P(x_k)), max over the 8 ambiguities.
"""

from __future__ import annotations

import torch

from .ser import _decode_levels

__all__ = ["mutual_information_ambiguity_mb_stats"]


def mutual_information_ambiguity_mb_stats(out_mb, mm_mb, s1_mb, tx, amps, P, nu_sc, var,
                                          weight=None, eps: float = 1e-12, tx_idx=None):
    """MI (bits per QAM symbol) per polarization from the demapper statistics.

    out_mb/mm_mb/s1_mb (..., n_mb, 2 pol, 2 comp, bl); tx (..., 2, 2, N)
    ALIGNED levels or tx_idx their indices; var (2,); weight broadcastable
    to (..., 2, N). Returns (..., 2).
    """
    n = amps.shape[0]
    n_mb, bl = out_mb.shape[-4], out_mb.shape[-1]

    def to_mb(a):  # (..., 2, N) time-major -> (..., n_mb, 2, bl)
        return a.reshape(a.shape[:-1] + (n_mb, bl)).movedim(-2, -3)

    amps_f = amps.to(torch.float32)
    idx = (_decode_levels(tx, n) if tx_idx is None else tx_idx).to(torch.int64)
    idx_i, idx_q = to_mb(idx[..., 0, :]), to_mb(idx[..., 1, :])
    lp = torch.log2(P.to(torch.float32))
    if weight is None:
        w = None
        red = lambda t: torch.sum(t, dim=(-3, -1))
    else:
        w = to_mb(torch.broadcast_to(weight.to(torch.float32), idx.shape[:-3] + (2, n_mb * bl)))
        red = lambda t: torch.sum(t * w, dim=(-3, -1))

    inv2v = (0.5 / var.to(torch.float32))[:, None]  # per pol
    o32, mm32, s132 = (a.to(torch.float32) for a in (out_mb, mm_mb, s1_mb))
    amps_r = amps_f.flip(0)
    a_i, a_ir = amps_f[idx_i], amps_r[idx_i]
    a_q, a_qr = amps_f[idx_q], amps_r[idx_q]

    def trace(comp, a_sel):
        d2 = (o32[..., comp, :] - a_sel) ** 2 * inv2v
        met = d2 + nu_sc * a_sel * a_sel
        q_sel = torch.exp(mm32[..., comp, :] - met) / s132[..., comp, :]
        return red(torch.log2(q_sel + eps))

    a1, a2 = trace(0, a_i), trace(0, a_ir)
    a3, a4 = trace(1, a_i), trace(1, a_ir)
    b1, b2 = trace(1, a_q), trace(1, a_qr)
    b3, b4 = trace(0, a_q), trace(0, a_qr)
    prior = red(lp[idx_i] + lp[idx_q])
    best = torch.stack(
        [a1 + b1, a2 + b2, a4 + b3, a3 + b4, a1 + b2, a2 + b1, a3 + b3, a4 + b4]
    ).max(dim=0).values
    if weight is None:
        return (best - prior) / (n_mb * bl)
    wsum = torch.sum(torch.broadcast_to(weight.to(torch.float32), idx.shape[:-3] + (2, n_mb * bl)), dim=-1)
    return (best - prior) / wsum
