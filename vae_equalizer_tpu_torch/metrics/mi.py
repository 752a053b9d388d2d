"""Mutual information from demapper posteriors, plain and over the blind
ambiguities (DP).

Port of ``vae_equalizer_tpu/metrics/mi.py: mutual_information,
mutual_information_ambiguity, mutual_information_ambiguity_mb_stats`` with
any leading batch dims. The mismatched-decoding estimate

    MI = (1/N) sum_k log2(q_k(x_k) / P(x_k))

at the transmitted symbols, summed over the two ASK dimensions of a square
QAM, is taken as it stands (``mutual_information``) or maximized over the 8
ambiguities, from the posteriors q (``mutual_information_ambiguity``, the CMA
path's soft demapper output) or rebuilt from the demapper's sufficient
statistics (``..._mb_stats``, the VAE kernel's streams): the PCS softmin
demapper computes q[l] = exp(mm - met_l) / s1 with met_l = (out - a_l)^2 /
(2 var) + nu_sc a_l^2, so (out, mm, s1) give the log-posterior at any
level. Level selections are direct indexing (``_level_select`` for
per-symbol tensors, plain indexing for level vectors): the JAX package's
compare-select sweeps existed because TPU gathers were slow.
"""

from __future__ import annotations

import torch

from .ser import _decode_levels

__all__ = ["mutual_information", "mutual_information_ambiguity",
           "mutual_information_ambiguity_mb_stats"]


def _level_select(lq: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """lq (..., n, N) picked at level indices idx (..., N) -> (..., N)."""
    return torch.gather(lq, -2, idx.to(torch.int64).unsqueeze(-2)).squeeze(-2)


def _take(vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """vec (n,) at level indices idx; or per run, vec (R, n) with row r
    taken at idx[r] (idx (R, ...))."""
    if vec.dim() == 1:
        return vec[idx]
    n = vec.shape[-1]
    off = torch.arange(vec.shape[0], device=idx.device) * n
    return vec.reshape(-1)[idx + off.reshape(off.shape + (1,) * (idx.dim() - 1))]


def mutual_information(q, tx, amps, P, weight=None, eps: float = 1e-12):
    """Per-symbol MI estimate in bits per QAM symbol from posteriors and the
    PCS prior (the sum of the two ASK dimensions).

    q (..., 2n, N) posteriors (I levels, then Q levels); tx (..., 2, N)
    transmitted amplitude levels; amps, P (n,); weight an optional (N,) (or
    broadcastable to it) mask of the symbols to include, normalized by its
    sum. Returns q's batch dims (per polarization for DP input).
    """
    n = amps.shape[0]
    idx = _decode_levels(tx, n).to(torch.int64)
    idx_i, idx_q = idx[..., 0, :], idx[..., 1, :]
    lp = torch.log2(P.to(torch.float32))
    trace = (_level_select(torch.log2(q[..., :n, :] + eps), idx_i) - lp[idx_i]
             + _level_select(torch.log2(q[..., n:, :] + eps), idx_q) - lp[idx_q])
    if weight is None:
        return torch.sum(trace, dim=-1) / tx.shape[-1]
    w = weight.to(torch.float32)
    return torch.sum(trace * w, dim=-1) / torch.sum(torch.broadcast_to(w, (tx.shape[-1],)))


def _best_of_ambiguities(a1, a2, a3, a4, b1, b2, b3, b4):
    """The 8 ambiguity hypotheses (rotations x IQ-flip) as sums of the
    selected traces, maximized (metrics/mi.py:118-130 of the JAX package)."""
    return torch.stack(
        [a1 + b1, a2 + b2, a4 + b3, a3 + b4, a1 + b2, a2 + b1, a3 + b3, a4 + b4]
    ).max(dim=0).values


def mutual_information_ambiguity(q, tx, amps, P, weight=None, eps: float = 1e-12):
    """MI (bits per QAM symbol) maximized over the 8 blind phase/IQ ambiguities.

    q (..., 2n, N) posteriors (I levels, then Q levels); tx (..., 2, N)
    amplitude levels, aligned; weight broadcastable to (..., N), with
    normalization per output element. Returns q's batch dims (per pol for
    DP input).
    """
    n = amps.shape[0]
    idx = _decode_levels(tx, n).to(torch.int64)
    idx_i, idx_q = idx[..., 0, :], idx[..., 1, :]
    idx_ir, idx_qr = (n - 1) - idx_i, (n - 1) - idx_q
    lqi = torch.log2(q[..., :n, :] + eps)
    lqq = torch.log2(q[..., n:, :] + eps)
    lp = torch.log2(P.to(torch.float32))
    if weight is None:
        red = lambda trace: torch.sum(trace, dim=-1)
    else:
        w = weight.to(torch.float32)
        red = lambda trace: torch.sum(trace * w, dim=-1)
    sel = lambda lq, i: red(_level_select(lq, i))
    best = _best_of_ambiguities(sel(lqi, idx_i), sel(lqi, idx_ir), sel(lqq, idx_i), sel(lqq, idx_ir),
                                sel(lqq, idx_q), sel(lqq, idx_qr), sel(lqi, idx_q), sel(lqi, idx_qr))
    prior = red(lp[idx_i] + lp[idx_q])
    if weight is None:
        return (best - prior) / tx.shape[-1]
    wsum = torch.sum(torch.broadcast_to(weight.to(torch.float32), best.shape + (tx.shape[-1],)), dim=-1)
    return (best - prior) / wsum


def mutual_information_ambiguity_mb_stats(out_mb, mm_mb, s1_mb, tx, amps, P, nu_sc, var,
                                          weight=None, eps: float = 1e-12, tx_idx=None):
    """MI (bits per QAM symbol) per polarization from the demapper statistics.

    out_mb/mm_mb/s1_mb (..., n_mb, 2 pol, 2 comp, bl); tx (..., 2, 2, N)
    ALIGNED levels or tx_idx their indices; var (2,), nu_sc a float and P
    (n,), or per run var (R, 2), nu_sc (R,) and P (R, n) over the leading
    runs axis; weight broadcastable to (..., 2, N). Returns (..., 2).
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

    inv2v = (0.5 / var.to(torch.float32))[..., None, :, None]  # per pol (and run)
    if torch.is_tensor(nu_sc):  # per run (R,)
        nu_sc = nu_sc.reshape(nu_sc.shape + (1, 1, 1))
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
    prior = red(_take(lp, idx_i) + _take(lp, idx_q))
    best = _best_of_ambiguities(a1, a2, a3, a4, b1, b2, b3, b4)
    if weight is None:
        return (best - prior) / (n_mb * bl)
    wsum = torch.sum(torch.broadcast_to(weight.to(torch.float32), idx.shape[:-3] + (2, n_mb * bl)), dim=-1)
    return (best - prior) / wsum
