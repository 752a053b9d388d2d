"""VAE ELBO losses, dual-pol and SISO (port of ``models/losses.py``).

    loss = sum_pol (N - Mh) log C_pol - sum q log(q / P)
    C_pol = ||rx||^2 - 2 <rx, h (*) E_q[x]> + ||h (*) E_q[x]||^2
            + sum_j |h_j|^2 Var_q[x]

The reference's per-tap loop (shared_funcs.py:123-129) is one 'valid'
convolution written as ``unfold`` + ``einsum`` (full float32, any leading
batch dims); the variance term uses the cumulative-sum window totals. The
reference's convention quirks are kept: the KL slice indexes symbols with
the sample-domain margin mh, and C aligns rx[mh + k] with D[Mh + k].
``elbo_siso`` takes any leading batch dims (the runs axis) and returns one
loss per run.
"""

from __future__ import annotations

import torch

__all__ = ["posterior_moments", "elbo_dp", "elbo_siso"]


def posterior_moments(q: torch.Tensor, amps: torch.Tensor, sps: int):
    """E_q[x], E_q[x^2] scattered onto the sps-upsampled grid.

    q (..., 2*num_lev, N_sym) -> (Eq, Eq2) each (..., 2, N_sym*sps), values
    at multiples of sps and zeros elsewhere.
    """
    n = amps.shape[0]
    a = amps[:, None]
    e_i = torch.sum(q[..., :n, :] * a, dim=-2)
    e_q = torch.sum(q[..., n:, :] * a, dim=-2)
    p_i = torch.sum(q[..., :n, :] * a * a, dim=-2)
    p_q = torch.sum(q[..., n:, :] * a * a, dim=-2)
    eq = torch.stack([e_i, e_q], dim=-2)
    eq2 = torch.stack([p_i, p_q], dim=-2)
    if sps > 1:
        up_shape = eq.shape[:-1] + (eq.shape[-1] * sps,)
        eq_up = torch.zeros(up_shape, dtype=eq.dtype, device=eq.device)
        eq2_up = torch.zeros(up_shape, dtype=eq.dtype, device=eq.device)
        eq_up[..., ::sps] = eq
        eq2_up[..., ::sps] = eq2
        eq, eq2 = eq_up, eq2_up
    return eq, eq2


def _windowed_sums(v: torch.Tensor, mh: int, n: int) -> torch.Tensor:
    """S[..., j] = sum_{t=Mh-j}^{N-1-j} v[..., t] for j = 0..Mh (Mh = 2*mh)."""
    mh2 = 2 * mh
    c = torch.cumsum(v, dim=-1)
    c = torch.cat([torch.zeros(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device), c], dim=-1)
    j = torch.arange(mh2 + 1, device=v.device)
    return c[..., n - j] - c[..., mh2 - j]


def conv_bank(h: torch.Tensor) -> torch.Tensor:
    """(..., chi, nu, 2, taps) channel estimate -> the flipped (…, 4, 4, taps)
    'valid' conv bank of D: out rows (chi, re/im), in rows (nu, I/Q)."""
    hr, hi = h[..., 0, :], h[..., 1, :]
    w_re = torch.stack([hr, -hi], dim=-2)  # (..., chi, nu, c, j)
    w_im = torch.stack([hi, hr], dim=-2)
    w = torch.stack([w_re, w_im], dim=-4)  # (..., chi, re/im, nu, c, j)
    return w.reshape(w.shape[:-5] + (4, 4, w.shape[-1])).flip(-1)


def elbo_dp(q: torch.Tensor, rx: torch.Tensor, h_est: torch.Tensor, amps: torch.Tensor,
            P: torch.Tensor, eps: float = 1e-12):
    """Dual-pol ELBO with PCS prior, any leading batch dims (the runs axis).

    q (..., 2, 2n, N_sym); rx (..., 2, 2, N); h_est (..., 2 out-pol, 2
    in-pol, 2, M). Returns (loss (...), var_est (..., 2)); var_est =
    C/(N-Mh) is detached.
    """
    n_samp = rx.shape[-1]
    sps = n_samp // q.shape[-1]
    mh = h_est.shape[-1] // 2
    mh2 = 2 * mh

    eq, eq2 = posterior_moments(q, amps, sps)  # (..., 2, 2, N)
    var = eq2 - eq * eq

    h = h_est[..., : mh2 + 1]
    w = conv_bank(h)
    cols = eq.reshape(eq.shape[:-3] + (4, n_samp)).unfold(-1, mh2 + 1, 1)  # (..., 4, N-Mh, taps)
    d = torch.einsum("...oij,...inj->...on", w, cols)
    d = d.reshape(d.shape[:-2] + (2, 2, n_samp - mh2))
    d_re, d_im = d[..., 0, :], d[..., 1, :]

    h_absq = torch.sum(h * h, dim=-2)  # (..., chi, nu, j)
    s = _windowed_sums(torch.sum(var, dim=-2), mh, n_samp)  # (..., nu, j)
    e_term = torch.einsum("...xnj,...nj->...x", h_absq, s)

    rx_w = rx[..., mh : n_samp - mh]
    c = torch.sum(rx_w * rx_w, dim=(-2, -1))
    c = c - 2.0 * torch.sum(rx_w[..., 0, :] * d_re + rx_w[..., 1, :] * d_im, dim=-1)
    c = c + torch.sum(d_re * d_re + d_im * d_im, dim=-1) + e_term

    q_c = q[..., mh : q.shape[-1] - mh]
    p_col = P.repeat(2)[:, None]
    kl = torch.sum(-q_c * torch.log(q_c / p_col + eps), dim=(-3, -2, -1))

    n_eff = n_samp - mh2
    loss = torch.sum(n_eff * torch.log(c), dim=-1) - kl
    return loss, (c / n_eff).detach()


def elbo_siso(q: torch.Tensor, rx: torch.Tensor, h_est: torch.Tensor, amps: torch.Tensor,
              P: torch.Tensor | None = None, eps: float = 1e-12) -> torch.Tensor:
    """SISO ELBO. q (..., 2n, N_sym); rx (..., 2, N); h_est (..., 2, M) -> loss (...).

    With ``P`` the entropy term is the KL against the PCS prior
    (func_VAELE_MQAM_shaping.py:63-95); with ``P=None`` it is the plain
    posterior entropy (uniform prior, func_VAENN_MQAM.py:60-91).
    """
    n_samp = rx.shape[-1]
    sps = n_samp // q.shape[-1]
    mh = h_est.shape[-1] // 2
    mh2 = 2 * mh

    eq, eq2 = posterior_moments(q, amps, sps)  # (..., 2, N)
    var = eq2 - eq * eq

    h = h_est[..., : mh2 + 1]
    hr, hi = h[..., 0, :], h[..., 1, :]
    # flipped 'valid' conv bank: out rows (re, im), in rows (I, Q)
    w = torch.stack([torch.stack([hr, -hi], dim=-2), torch.stack([hi, hr], dim=-2)], dim=-3).flip(-1)
    d = torch.einsum("...oij,...inj->...on", w, eq.unfold(-1, mh2 + 1, 1))  # (..., 2, N - Mh)
    d_re, d_im = d[..., 0, :], d[..., 1, :]

    s = _windowed_sums(torch.sum(var, dim=-2), mh, n_samp)  # (..., taps)
    e_term = torch.sum((hr * hr + hi * hi) * s, dim=-1)

    rx_w = rx[..., mh : n_samp - mh]
    c = torch.sum(rx_w * rx_w, dim=(-2, -1))
    c = c - 2.0 * torch.sum(rx_w[..., 0, :] * d_re + rx_w[..., 1, :] * d_im, dim=-1)
    c = c + torch.sum(d_re * d_re + d_im * d_im, dim=-1) + e_term

    q_c = q[..., mh : q.shape[-1] - mh]
    if P is None:
        ent = torch.sum(-q_c * torch.log(q_c + eps), dim=(-2, -1))
    else:
        ent = torch.sum(-q_c * torch.log(q_c / P.repeat(2)[:, None] + eps), dim=(-2, -1))
    return (n_samp - mh2) * torch.log(c) - ent
