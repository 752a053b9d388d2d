"""Kernel A: one DP VAE minibatch — loss, var_est and closed-form gradients.

Replaces the TPU kernel ``vae_equalizer_tpu/ops/elbo_kernel.py:
vae_dp_loss_and_grad_pallas`` (pallas_call at :361). Computes the fused
butterfly -> PCS softmin demapper -> DP ELBO forward and the hand-derived
backward of ``vae_equalizer_tpu/ops/elbo_vjp.py`` (derivation there), for R
runs' minibatches in one launch (the JAX package vmaps the per-run call):

    loss (R,), var_est (R, 2), gw (R, 2, 4, M), gh (R, 2, 2, 2, M),
    q (R, 2, 2n, N), out (R, 2, 2, N)

It is the step of the per-step training modes (``train/dp.py``,
``use_pallas=True``). The CUDA body (``csrc/dp_step.cuh``) is shared with
kernel B (``ops/frame_kernel.py``), which runs it for all of a frame's
minibatches.

On the card: one minibatch is ~0.2 MFLOP over a ~40 KB working set, so a
launch is bound by latency — the dependent phases of the step (forward,
demapper, D conv, reductions, backward) — not by bytes or FLOPs. The design
(``csrc/dp_step.cuh``) keeps every intermediate of the step in one 512-thread
block's shared memory, runs each dot product as one fused chain in this
file's contraction order (so its rounding stays that of ``dp_step_plain``),
and closes the block totals with per-warp partials and one warp (no
atomics, so results repeat bit for bit); grid = R, one block per run, each
reading its minibatch in place from the frame row, in the kernel's 8-level
instance at 64-QAM and its generic one at any other level count.

Dispatch: a CPU tensor takes ``vae_dp_loss_and_grad_plain`` (the plain
PyTorch version, also the reference the kernel is checked against on the
card); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..models.losses import conv_bank
from ..models.vae_le import _arrangements, _im2col, butterfly_apply
from . import _build

__all__ = [
    "VaeDpLoss",
    "dp_step_plain",
    "vae_dp_loss_and_grad",
    "vae_dp_loss_and_grad_plain",
]

EPS_KL = 1e-12


def dp_step_plain(w, h, x, amps, var, nu_sc, P, eps: float = EPS_KL) -> dict:
    """Plain PyTorch minibatch step, any leading batch dims (the runs axis).

    w (..., 2, 4, M); h (..., 2, 2, 2, M); x (..., 2, 2, 2*N); amps (n,);
    var (2,) or (..., 2); nu_sc a float or a tensor (...,); P (n,) or
    (..., n). sps = 2 and odd M, as the kernel. Returns a dict:
    loss (...), var_est (..., 2), gw (..., 2, 4, M), gh (..., 2, 2, 2, M),
    q (..., 2, 2, n, N), out / mm / s1 / eq (..., 2, 2, N) and dec
    (..., 2, 2, N) the int64 argmax level.

    C is evaluated as sum (rx_w - D)^2 + E, algebraically the JAX closed
    form's ||rx||^2 - 2<rx, D> + ||D||^2 + E without its cancellation.
    """
    m = w.shape[-1]
    if m % 2 != 1 or h.shape[-1] != m:
        raise ValueError(f"odd tap count M shared by w and h required, got {m} and {h.shape[-1]}")
    n_samp = x.shape[-1]
    n_sym = n_samp // 2
    n_lev = amps.shape[0]
    mh = m // 2
    mh2 = 2 * mh
    n_eff = n_samp - mh2
    var = var.expand(x.shape[:-3] + (2,))
    if torch.is_tensor(nu_sc):  # per run: (...,) against (..., pol, I/Q, level, t)
        nu_sc = nu_sc[..., None, None, None, None]
    if P.dim() > 1:  # per run: (..., n) against (..., pol, I/Q, level, t)
        P = P[..., None, None, :]
    a = amps[:, None]

    # ---- forward: butterfly, demapper with its sufficient statistics
    out = butterfly_apply(w, x, 2)  # (..., 2, 2, N)
    dd = out[..., None, :] - a  # (..., 2, 2, n, N)
    met = dd * dd / (2.0 * var[..., :, None, None, None]) + nu_sc * (amps * amps)[:, None]
    mm = met.min(dim=-2).values
    e = torch.exp(mm[..., None, :] - met)
    s1 = e.sum(dim=-2)
    q = e / s1[..., None, :]
    dec = torch.argmax(q, dim=-2)
    eq = torch.sum(q * a, dim=-2)  # (..., 2, 2, N)
    v = torch.sum(q * (a * a), dim=-2) - eq * eq

    # ---- ELBO: D = h (*) EqUp ('valid'), E term, C, KL
    up = lambda t: torch.stack([t, torch.zeros_like(t)], dim=-1).flatten(-2)  # zero-insert
    eq_up = up(eq)  # (..., 2, 2, n_samp)
    cols = eq_up.reshape(eq_up.shape[:-3] + (4, n_samp)).unfold(-1, mh2 + 1, 1)
    d = torch.einsum("...oij,...inj->...on", conv_bank(h), cols)
    d = d.reshape(d.shape[:-2] + (2, 2, n_eff))  # (..., chi, re/im, n_eff)
    h_absq = torch.sum(h * h, dim=-2)  # (..., chi, nu, j)
    vsum = up(v.sum(dim=-2))  # (..., nu, n_samp)
    s = vsum.unfold(-1, n_eff, 1).sum(dim=-1).flip(-1)  # S[nu, j], window [Mh-j, N-j)
    e_term = torch.einsum("...xnj,...nj->...x", h_absq, s)
    rx_w = x[..., mh : n_samp - mh]
    c = torch.sum((rx_w - d) ** 2, dim=(-2, -1)) + e_term  # (..., 2)
    t_in = torch.zeros(n_sym, dtype=x.dtype, device=x.device)
    t_in[mh : n_sym - mh] = 1.0
    ratio = q / P[..., :, None]
    kl = torch.sum(-q * torch.log(ratio + eps) * t_in, dim=(-4, -3, -2, -1))
    loss = n_eff * (torch.log(c[..., 0]) + torch.log(c[..., 1])) - kl

    # ---- backward (elbo_vjp.vae_dp_loss_bwd, dL/dloss = 1)
    g_c = n_eff / c  # (..., 2)
    g_d = g_c[..., :, None, None] * (2.0 * d - 2.0 * rx_w)  # (..., chi, c, n_eff)
    # gh: eq_sl[nu, c, j, n] = EqUp[nu, c, Mh + n - j]
    eq_sl = eq_up.unfold(-1, n_eff, 1).flip(-2)  # (..., nu, c, j, n)
    ghr = torch.einsum("...xn,...vjn->...xvj", g_d[..., 0, :], eq_sl[..., 0, :, :]) + torch.einsum(
        "...xn,...vjn->...xvj", g_d[..., 1, :], eq_sl[..., 1, :, :])
    ghi = torch.einsum("...xn,...vjn->...xvj", g_d[..., 1, :], eq_sl[..., 0, :, :]) - torch.einsum(
        "...xn,...vjn->...xvj", g_d[..., 0, :], eq_sl[..., 1, :, :])
    gh = torch.stack([ghr, ghi], dim=-2) + 2.0 * g_c[..., :, None, None, None] * h * s[..., None, :, None, :]
    # gEqUp at the even (symbol) samples: gd_sl[chi, c, p, j] = g_d[chi, c, p + j - Mh]
    gd_sl = torch.nn.functional.pad(g_d, (mh2, mh2)).unfold(-1, mh2 + 1, 1)[..., ::2, :]
    hr, hi = h[..., 0, :], h[..., 1, :]  # (..., chi, nu, j)
    g_eq_i = torch.einsum("...xpj,...xvj->...vp", gd_sl[..., 0, :, :], hr) + torch.einsum(
        "...xpj,...xvj->...vp", gd_sl[..., 1, :, :], hi)
    g_eq_q = torch.einsum("...xpj,...xvj->...vp", gd_sl[..., 1, :, :], hr) - torch.einsum(
        "...xpj,...xvj->...vp", gd_sl[..., 0, :, :], hi)
    # gV through the E term: per-sample tap-window mask at the even samples
    p_idx = torch.arange(0, n_samp, 2, device=x.device)
    j_idx = torch.arange(mh2 + 1, device=x.device)
    win = ((p_idx[None, :] >= mh2 - j_idx[:, None]) & (p_idx[None, :] < n_samp - j_idx[:, None])).to(x.dtype)
    g_v = torch.einsum("...x,...xvj,jp->...vp", g_c, h_absq, win)  # (..., nu, N)
    g_eq = torch.stack([g_eq_i, g_eq_q], dim=-2) - 2.0 * eq * g_v[..., :, None, :]
    gq = a * g_eq[..., None, :] + (a * a) * g_v[..., :, None, None, :]
    gq = gq + (torch.log(ratio + eps) + ratio / (ratio + eps)) * t_in
    inner = torch.sum(q * gq, dim=-2, keepdim=True)
    gm = -q * (gq - inner)
    g_out = torch.sum(gm * dd, dim=-2) / var[..., :, None, None]  # (..., 2, 2, N)
    x_i, x_q = _arrangements(x)
    gw = torch.einsum("...ot,...itk->...oik", g_out[..., 0, :], _im2col(x_i, m, 2)) + torch.einsum(
        "...ot,...itk->...oik", g_out[..., 1, :], _im2col(x_q, m, 2))

    return dict(loss=loss, var_est=c / n_eff, gw=gw, gh=gh, q=q, out=out, mm=mm, s1=s1,
                dec=dec, eq=eq)


def vae_dp_loss_and_grad_plain(w, h, x, amps, var, nu_sc: float, P, eps: float = EPS_KL):
    """Plain version of kernel A: (loss, var_est, gw, gh, q (2, 2n, N), out)."""
    st = dp_step_plain(w, h, x, amps, var, nu_sc, P, eps)
    q = st["q"].flatten(-3, -2)  # (..., 2, 2, n, N) -> (..., 2, 2n, N)
    return st["loss"], st["var_est"], st["gw"], st["gh"], q, st["out"]


def vae_dp_loss_and_grad(w, h, x, amps, var, nu_sc: float, P):
    """Kernel A for R runs in one launch, or one run without the runs axis.

    w (R, 2, 4, M), h (R, 2, 2, 2, M), x (R, 2, 2, 2N) -> (loss (R,),
    var_est (R, 2), gw, gh, q (R, 2, 2n, N), out (R, 2, 2, N)); amps/P (n,),
    var (2,). ``x`` may be a window of longer frame rows (last axis
    contiguous, the four rows evenly spaced, as a slice of the simulator's
    (R, 2, 2, Nsamp) output): the kernel reads it in place. CPU tensors take
    the plain version."""
    if not x.is_cuda:
        return vae_dp_loss_and_grad_plain(w, h, x, amps, var, nu_sc, P)
    return _launch(w, h, x, amps, var, nu_sc, P)


def _launch(w, h, x, amps, var, nu_sc: float, P):
    dev = x.device
    m = w.shape[-1]
    n_samp = x.shape[-1]
    n_sym = n_samp // 2
    n_lev = amps.shape[0]
    if m % 2 != 1 or n_samp % 2 != 0:
        raise ValueError("kernel A needs odd M and an even sample count (sps = 2)")
    lead = tuple(w.shape[:-3])
    if len(lead) > 1:
        raise ValueError(f"w: expected (2, 4, M) or (R, 2, 4, M), got {tuple(w.shape)}")
    R = lead[0] if lead else 1
    for name, t, shape in (("w", w, lead + (2, 4, m)), ("h", h, lead + (2, 2, 2, m)),
                           ("amps", amps, (n_lev,)), ("P", P, (n_lev,)), ("var", var, (2,))):
        _build.check_tensor(name, t, shape, dev)
    if x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != lead + (2, 2, n_samp):
        raise ValueError(f"x: expected a float32 tensor of shape {lead + (2, 2, n_samp)} on {dev}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    row = x.stride(-2)
    if x.stride(-1) != 1 or x.stride(-3) != 2 * row or row < n_samp:
        raise ValueError(f"x: needs a contiguous last axis and evenly spaced rows, got strides "
                         f"{x.stride()}")
    lib = _build.load()
    f32 = dict(dtype=torch.float32, device=dev)
    stats = torch.empty(lead + (3,), **f32)
    gw = torch.empty(lead + (2, 4, m), **f32)
    gh = torch.empty(lead + (2, 2, 2, m), **f32)
    q = torch.empty(lead + (2, 2 * n_lev, n_sym), **f32)
    out = torch.empty(lead + (2, 2, n_sym), **f32)
    rc = lib.vae_dp_step_launch(
        R, x.data_ptr(), x.stride(0) if lead else 0, row,
        *(t.data_ptr() for t in (w, h, amps, P, var)), nu_sc, n_sym, m, n_lev,
        *(t.data_ptr() for t in (stats, gw, gh, q, out)), _build.stream(dev))
    _build.check(rc, "vae_dp_step_launch")
    _build.count_launch(vae_dp_loss_and_grad)
    return stats[..., 0], stats[..., 1:3], gw, gh, q, out


_build.counted(vae_dp_loss_and_grad)


class VaeDpLoss(torch.autograd.Function):
    """The fused DP loss as an autograd node: forward runs kernel A (or its
    plain version on the CPU) and saves gw/gh; backward scales them by the
    incoming gradient (per run, with a runs axis). Returns (loss, var_est);
    var_est carries no gradient."""

    @staticmethod
    def forward(ctx, w, h, x, amps, var, nu_sc, P):
        loss, var_est, gw, gh, _, _ = vae_dp_loss_and_grad(w, h, x, amps, var, nu_sc, P)
        ctx.save_for_backward(gw, gh)
        ctx.mark_non_differentiable(var_est)
        return loss, var_est

    @staticmethod
    def backward(ctx, g_loss, g_var_est):
        gw, gh = ctx.saved_tensors
        g = g_loss[..., None, None, None]
        return g * gw, g[..., None] * gh, None, None, None, None, None
