"""Eval masks and alignment for the DP frame and the AWGN evaluations.

Port of ``vae_equalizer_tpu/train/eval_utils.py: align_idx_dp, align_tx_dp,
batch_cut_weight, margin_weight, margin_weight_maxshift, roll_dp,
roll_time`` with any leading batch dims. The reference's data-dependent
slices become a roll + boolean weight over the full array; the masks are evaluated at the shifted positions t directly
(not rolled), exactly as in the JAX package. The JAX package's gather-free
``roll_bits`` was a TPU workaround; here the per-run roll is one
``torch.gather`` on ``(arange - s) % n``, so every run may have its own shift.
"""

from __future__ import annotations

import torch

__all__ = ["MARGIN", "align_idx_dp", "align_tx_dp", "batch_cut_weight", "margin_weight",
           "margin_weight_maxshift", "roll_dp", "roll_time"]

MARGIN = 11  # the reference's fixed edge trim (func_VAELE_MQAM_shaping.py:318)


def align_idx_dp(idx: torch.Tensor, shift: torch.Tensor, r: torch.Tensor, weight_fn_t):
    """Roll tx level indices + eval weight into the equalizer's frame.

    idx (..., 2, 2, N) tx level indices; shift (..., 2); r (...) pol swap;
    weight_fn_t(t) -> (..., 2, N) builds the mask at positions t (..., 2, N).
    Returns (idx_al (..., 2, 2, N), w_al (..., 2, N)): per equalizer pol j,
    the tx pol (j + r) % 2 rolled by its shift.
    """
    n = idx.shape[-1]
    swap = r != 0
    idx_p = torch.where(swap[..., None, None, None], idx.flip(-3), idx)
    s_p = torch.where(swap[..., None], shift.flip(-1), shift).to(torch.int64)
    t = torch.remainder(torch.arange(n, device=idx.device) - s_p[..., None], n)  # (..., 2, N)
    idx_al = torch.gather(idx_p, -1, t[..., None, :].expand(idx_p.shape))
    return idx_al, weight_fn_t(t)


def align_tx_dp(tx: torch.Tensor, shift: torch.Tensor, r: torch.Tensor, weight: torch.Tensor):
    """``align_idx_dp`` for tx amplitude levels and a precomputed weight.

    tx (..., 2, 2, N); weight (..., N) (or (N,)). Returns (tx_al (..., 2,
    2, N), w_al (..., 2, N)): per equalizer pol j, the tx pol (j + r) % 2 and
    the weight rolled by that pol's shift.
    """
    def rolled_weight(t):
        w = torch.broadcast_to(weight[..., None, :], t.shape[:-1] + weight.shape[-1:])
        return torch.gather(w, -1, t)

    return align_idx_dp(tx, shift, r, rolled_weight)


def roll_time(x: torch.Tensor, shift) -> torch.Tensor:
    """Roll by -shift along time, per run: x (*b, C, n), shift (*b) ->
    x'[..., t] = x[..., (t + shift) % n]."""
    n = x.shape[-1]
    s = torch.as_tensor(shift, device=x.device).to(torch.int64)
    t = torch.remainder(torch.arange(n, device=x.device) + s[..., None, None], n)
    return torch.gather(x, -1, t.expand(x.shape))


def roll_dp(x: torch.Tensor, shift, r) -> torch.Tensor:
    """Compensate the DP pol assignment r and the per-pol time shift (2,):
    x (2, ...) rolled by r along the pol axis, then pol p rolled by
    -shift[p] along time. The form the aligned eval (``align_tx_dp``) is
    held against."""
    x = torch.roll(x, int(r), dims=0)
    return torch.stack([torch.roll(x[p], -int(shift[p]), dims=-1) for p in range(2)])


def margin_weight(n: int, shift, margin: int = MARGIN) -> torch.Tensor:
    """Weight for the reference's ``x[margin+shift:-margin]`` vs
    ``tx[margin:-margin-shift]`` comparison after ``roll_time(x, shift)``:
    positions t in [margin, n - margin - shift), (*b, n) for shift (*b)."""
    s = torch.as_tensor(shift)
    t = torch.arange(n, device=s.device)
    return ((t >= margin) & (t < n - margin - s[..., None])).to(torch.float32)


def margin_weight_maxshift(n: int, max_shift, margin: int = MARGIN, t=None) -> torch.Tensor:
    """Weight for the flex/CMA eval trim ``[..., margin : -margin - max|shift|]``,
    over ``arange(n)`` or evaluated at positions ``t``."""
    if t is None:
        t = torch.arange(n)
    return ((t >= margin) & (t < n - margin - max_shift)).to(torch.float32)


def batch_cut_weight(m_max: int, batch_len: int, shift0, max_shift, n_cut: int,
                     margin: int = MARGIN, t=None) -> torch.Tensor:
    """Weight of the DP VAE eval bookkeeping (func_VAELE_DP_MQAM_shaping.py:73-79).

    Per batch keep the first batch_len - shift0 - n_cut symbols, flatten,
    then trim [margin : -margin - max_shift]; returned over the flat
    (m_max * batch_len,) symbol order, or evaluated at positions ``t``.
    ``shift0``/``max_shift`` may be tensors broadcastable against ``t``.
    """
    if t is None:
        t = torch.arange(m_max * batch_len)
    j = t % batch_len
    mb = t // batch_len
    keep_len = batch_len - shift0 - n_cut
    pos = mb * keep_len + j
    w = (j < keep_len) & (pos >= margin) & (pos < m_max * keep_len - margin - max_shift)
    return w.to(torch.float32)
