"""Time-shift (and, for DP, polarization-assignment) search by correlation.

Port of ``vae_equalizer_tpu/metrics/sync.py: expectation_i, _roll_stack,
find_shift_siso, find_shift_symb_siso, _dp_shift_core, find_shift_dp,
find_shift_symb_dp`` with any leading batch dims (the runs axis). The equalizer output (E_q[x^I] or the in-phase
constellation output) is
correlated against the known transmitted symbols over ``n_shift`` cyclic
shifts of the first ``corr_len`` symbols; argmaxes take the first maximum and
the XY/YX tie goes to XY (``>=``), as in the JAX package.
"""

from __future__ import annotations

import torch

__all__ = ["expectation_i", "find_shift_dp", "find_shift_siso", "find_shift_symb_dp",
           "find_shift_symb_siso"]


def expectation_i(q: torch.Tensor, amps: torch.Tensor) -> torch.Tensor:
    """E_q[x^I], the posterior mean of the in-phase component:
    q (..., 2 num_lev, N) -> (..., N)."""
    num_lev = amps.shape[0]
    return torch.sum(q[..., :num_lev, :] * amps[:, None], dim=-2)


def _roll_stack(e: torch.Tensor, n_shift: int) -> torch.Tensor:
    """(..., L) -> (..., n_shift, L) where [..., i, :] = roll(e, i - n_shift//2)."""
    return torch.stack(
        [torch.roll(e, s, dims=-1) for s in range(-(n_shift // 2), n_shift - n_shift // 2)], dim=-2
    )


def find_shift_siso(q: torch.Tensor, tx: torch.Tensor, n_shift: int, amps: torch.Tensor,
                    corr_len: int = 1000) -> torch.Tensor:
    """Time shift between SISO posteriors q (..., 2n, L) and tx (..., 2, L).

    Correlates E_q[x^I] over the first ``corr_len`` symbols; falls back to
    the Q component where the I correlation peak is weak (below 0.02 L).
    Returns (...) int32.
    """
    e_mat = _roll_stack(expectation_i(q, amps)[..., :corr_len], n_shift)  # (..., s, l)
    txc = tx[..., :corr_len].to(torch.float32)
    corr_i = torch.einsum("...sl,...l->...s", e_mat, txc[..., 0, :]).abs()
    corr_q = torch.einsum("...sl,...l->...s", e_mat, txc[..., 1, :]).abs()
    s_i = n_shift // 2 - torch.argmax(corr_i, dim=-1)
    s_q = n_shift // 2 - torch.argmax(corr_q, dim=-1)
    max_i = corr_i.max(dim=-1).values
    use_i = max_i >= 0.02 * q.shape[-1]
    use_q = corr_q.max(dim=-1).values >= max_i
    return torch.where(use_i, s_i, torch.where(use_q, s_q, s_i)).to(torch.int32)


def find_shift_symb_siso(rx: torch.Tensor, tx: torch.Tensor, n_shift: int,
                         corr_len: int = 1000) -> torch.Tensor:
    """Time shift from the raw SISO constellation output rx (..., 2, L) against
    tx (..., 2, L) (func_CMA_MQAM_shaping.py:127-140): correlates the windows
    rx^I[i : corr_len - n_shift//2 + i] with tx[n_shift//2 : corr_len]; a
    positive result means rx lags tx. Falls back to the Q component where the
    I peak is weak (below 0.02 L). Returns (...) int32.
    """
    m = corr_len - n_shift // 2
    mat = rx[..., 0, : m + n_shift - 1].unfold(-1, n_shift, 1)  # (..., m, n_shift)
    txc = tx[..., n_shift // 2 : corr_len].to(torch.float32)
    corr_i = torch.einsum("...l,...ls->...s", txc[..., 0, :], mat).abs()
    corr_q = torch.einsum("...l,...ls->...s", txc[..., 1, :], mat).abs()
    s_i = torch.argmax(corr_i, dim=-1) - n_shift // 2
    s_q = torch.argmax(corr_q, dim=-1) - n_shift // 2
    max_i = corr_i.max(dim=-1).values
    use_i = max_i >= 0.02 * rx.shape[-1]
    use_q = corr_q.max(dim=-1).values >= max_i
    return torch.where(use_i, s_i, torch.where(use_q, s_q, s_i)).to(torch.int32)


def _dp_shift_core(e: torch.Tensor, tx: torch.Tensor, n_shift: int, corr_len: int | None = None):
    """e (..., 2, L) correlation signal per equalizer pol; tx (..., 2, 2, L).

    Returns (shift (..., 2) int32, r (...) int32), r = 0 for the XY
    assignment, 1 for YX.
    """
    if corr_len is not None and corr_len < e.shape[-1]:
        e = e[..., :corr_len]
        tx = tx[..., :corr_len]
    e_mat = _roll_stack(e, n_shift)  # (..., b, s, L)
    corr = torch.einsum("...icl,...bsl->...cbis", tx.to(torch.float32), e_mat).abs()
    corr_max_c = corr.max(dim=-1).values  # (..., comp, b, i)
    corr_ind_c = torch.argmax(corr, dim=-1)
    ind_max = torch.argmax(corr_max_c, dim=-3)  # (..., b, i) best component
    corr_max = corr_max_c.max(dim=-3).values
    pick = torch.gather(corr_ind_c, -3, ind_max.unsqueeze(-3)).squeeze(-3)  # (..., b, i)
    ind_xy = torch.stack([pick[..., 0, 0], pick[..., 1, 1]], dim=-1)
    ind_yx = torch.stack([pick[..., 0, 1], pick[..., 1, 0]], dim=-1)
    use_xy = corr_max[..., 0, 0] + corr_max[..., 1, 1] >= corr_max[..., 0, 1] + corr_max[..., 1, 0]
    shift = torch.where(use_xy[..., None], n_shift // 2 - ind_xy, n_shift // 2 - ind_yx)
    r = torch.where(use_xy, 0, 1)
    return shift.to(torch.int32), r.to(torch.int32)


def find_shift_symb_dp(rx: torch.Tensor, tx: torch.Tensor, n_shift: int,
                       corr_len: int | None = None):
    """Pol assignment + time shift from DP constellation output rx (..., 2, 2, L)."""
    return _dp_shift_core(rx[..., :, 0, :], tx, n_shift, corr_len)


def find_shift_dp(q: torch.Tensor, tx: torch.Tensor, n_shift: int, amps: torch.Tensor,
                  corr_len: int | None = None):
    """Pol assignment + per-pol time shift from DP posteriors q (..., 2, 2n, L)."""
    return _dp_shift_core(expectation_i(q, amps), tx, n_shift, corr_len)
