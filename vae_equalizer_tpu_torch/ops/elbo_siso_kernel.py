"""Kernel F: one SISO VAE minibatch for R runs — loss and closed-form gradients.

Replaces the TPU kernel ``vae_equalizer_tpu/ops/elbo_siso_kernel.py:
vae_siso_loss_and_grad_pallas`` (pallas_call at :283), the pol = 1 case of
kernel A for the AWGN VAE-LE experiment: twoFIR -> per-component mean-|.|
normalization -> Gaussian soft demapper (metric d^2 / var, no PCS term) ->
shaped SISO ELBO, plus the hand-derived backward for (w, h). The
normalization norm_c = out_c k_c, k_c = amp_mean / mean|out_c|, adds one VJP
link the DP step does not have:

    gout_c = k_c (gnorm_c - sign(out_c) <gnorm_c, norm_c> / (N amp_mean))

Returns (loss, gw (..., 1, 2, M), gh (..., 2, M), q (..., 2n, N),
out (..., 2, N)); the JAX kernel takes one run, this one takes all R runs of
a leading runs axis in one launch.

On the card (``csrc/siso_kernels.cu`` + ``siso_step.cuh``): grid = R, one
512-thread block per run, every intermediate of the step in the block's
shared memory (~79 KB at 64-QAM, bl 350, M 25), the step in six passes with
one barrier each, sums over time split over lanes and closed by fixed
shuffle trees, block totals by per-warp shuffles and a fixed cross-warp
order (no atomics, so a run repeats bit for bit), divisions branch-free
and exact (the design and its per-phase clocks: ``siso_step.cuh``,
PERF.md). A minibatch is ~0.5 MFLOP over that working set: a launch is
bound by the chain of dependent passes (latency), not by bytes or FLOPs.
The TPU layout (polyphase rows, per-tap (8, 2) weight blocks) answered
Mosaic's constraints and is not carried over. ``siso_step_clocks`` runs the
kernel once with its block's per-phase clock64() cycles (measurement
only).

Dispatch: a CPU tensor takes ``vae_siso_loss_and_grad_plain``; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..models.vae_le import siso_arrangements, siso_windows
from . import _build

__all__ = ["SISO_CLOCK_PHASES", "siso_step_clocks", "siso_step_plain", "vae_siso_loss_and_grad",
           "vae_siso_loss_and_grad_plain"]

EPS_KL = 1e-12
# the step's phases, in the order of csrc/siso_step.cuh: enum Phase (kernels F and G)
SISO_CLOCK_PHASES = ("load x", "FIR+|out|", "demapper+KL", "D+C+S", "gh+gq->gnorm", "gout",
                     "gw+AMSGrad")


def _upsample2(t: torch.Tensor) -> torch.Tensor:
    """Zero-insertion upsampling by 2 along the last axis."""
    return torch.stack([t, torch.zeros_like(t)], dim=-1).flatten(-2)


def siso_step_plain(w, h, x, amps, amp_mean: float, var: float, P, eps: float = EPS_KL) -> dict:
    """Plain PyTorch minibatch step, any leading batch dims (the runs axis).

    w (..., 1, 2, M); h (..., 2, M); x (..., 2, 2N); amps/P (n,). sps = 2
    and odd M, as the kernel. The math follows the TPU kernel
    (elbo_siso_kernel.py:57-240) line for line, except that C is evaluated
    as sum (rx_w - D)^2 + E, algebraically its ||rx||^2 - 2<rx, D> +
    ||D||^2 + E without the cancellation. Returns a dict: loss (...),
    gw (..., 1, 2, M), gh (..., 2, M), q (..., 2, n, N), out (..., 2, N).
    """
    m = w.shape[-1]
    if m % 2 != 1 or h.shape[-1] != m:
        raise ValueError(f"odd tap count M shared by w and h required, got {m} and {h.shape[-1]}")
    n_samp = x.shape[-1]
    n_sym = n_samp // 2
    mh = m // 2
    mh2 = 2 * mh
    n_eff = n_samp - mh2
    a = amps[:, None]

    # ---- forward: FIR, mean-|.| normalization, demapper and its moments
    wins = [siso_windows(xa, m, 2) for xa in siso_arrangements(x)]  # (..., 2, N, M) each
    taps = w[..., 0, :, :]
    out = torch.stack([torch.einsum("...ck,...cnk->...n", taps, win) for win in wins], dim=-2)
    k = amp_mean / (out.abs().sum(dim=-1) / n_sym)  # (..., 2)
    norm = out * k[..., None]
    dd = norm[..., None, :] - a  # (..., 2, n, N)
    met = dd * dd / var
    e = torch.exp(met.min(dim=-2, keepdim=True).values - met)
    q = e / e.sum(dim=-2, keepdim=True)
    eq = torch.sum(q * a, dim=-2)  # (..., 2, N)
    v = torch.sum(q * (a * a), dim=-2) - eq * eq

    # ---- ELBO: D = h (*) EqUp ('valid'), E term, C, KL over the inner symbols
    eq_up = _upsample2(eq)  # (..., 2, n_samp)
    hr, hi = h[..., 0, :], h[..., 1, :]
    bank = torch.stack([torch.stack([hr, -hi], dim=-2), torch.stack([hi, hr], dim=-2)], dim=-3).flip(-1)
    d = torch.einsum("...oij,...inj->...on", bank, eq_up.unfold(-1, mh2 + 1, 1))  # (..., 2, n_eff)
    h_absq = hr * hr + hi * hi
    s = _upsample2(v.sum(dim=-2)).unfold(-1, n_eff, 1).sum(dim=-1).flip(-1)  # S[j], window [Mh-j, N-j)
    rx_w = x[..., mh : n_samp - mh]
    c = torch.sum((rx_w - d) ** 2, dim=(-2, -1)) + torch.sum(h_absq * s, dim=-1)
    t_in = torch.zeros(n_sym, dtype=x.dtype, device=x.device)
    t_in[mh : n_sym - mh] = 1.0
    ratio = q / P[:, None]
    kl = torch.sum(-q * torch.log(ratio + eps) * t_in, dim=(-3, -2, -1))
    loss = n_eff * torch.log(c) - kl

    # ---- backward (dL/dloss = 1)
    g_c = n_eff / c
    g_d = g_c[..., None, None] * (2.0 * d - 2.0 * rx_w)  # (..., re/im, n_eff)
    # gh: eq_sl[c, j, n] = EqUp[c, Mh - j + n]
    eq_sl = eq_up.unfold(-1, n_eff, 1).flip(-2)
    dot_n = lambda g, e_: torch.einsum("...n,...jn->...j", g, e_)
    ghr = dot_n(g_d[..., 0, :], eq_sl[..., 0, :, :]) + dot_n(g_d[..., 1, :], eq_sl[..., 1, :, :])
    ghi = dot_n(g_d[..., 1, :], eq_sl[..., 0, :, :]) - dot_n(g_d[..., 0, :], eq_sl[..., 1, :, :])
    gh = torch.stack([ghr, ghi], dim=-2) + 2.0 * g_c[..., None, None] * h * s[..., None, :]
    # gEq at the symbol samples 2t: gd_sl[c, t, j] = g_d[c, 2t + j - Mh]
    gd_sl = torch.nn.functional.pad(g_d, (mh2, mh2)).unfold(-1, mh2 + 1, 1)[..., ::2, :]
    dot_j = lambda g, h_: torch.einsum("...tj,...j->...t", g, h_)
    g_eq_i = dot_j(gd_sl[..., 0, :, :], hr) + dot_j(gd_sl[..., 1, :, :], hi)
    g_eq_q = dot_j(gd_sl[..., 1, :, :], hr) - dot_j(gd_sl[..., 0, :, :], hi)
    # gV through the E term: the tap window mask at the symbol samples
    ps = torch.arange(0, n_samp, 2, device=x.device)
    j_idx = torch.arange(m, device=x.device)
    win = ((ps[None, :] >= mh2 - j_idx[:, None]) & (ps[None, :] < n_samp - j_idx[:, None])).to(x.dtype)
    g_v = g_c[..., None] * torch.einsum("...j,jt->...t", h_absq, win)  # (..., N)
    g_eq = torch.stack([g_eq_i, g_eq_q], dim=-2) - 2.0 * eq * g_v[..., None, :]
    gq = a * g_eq[..., None, :] + (a * a) * g_v[..., None, None, :]
    gq = gq + (torch.log(ratio + eps) + ratio / (ratio + eps)) * t_in
    gm = -q * (gq - torch.sum(q * gq, dim=-2, keepdim=True))
    gnorm = torch.sum(gm * 2.0 * dd, dim=-2) / var  # (..., 2, N)
    # normalization VJP per component
    dot = torch.sum(gnorm * norm, dim=-1)  # (..., 2)
    gout = k[..., None] * (gnorm - torch.sign(out) * (dot / (n_sym * amp_mean))[..., None])
    gw = torch.einsum("...t,...ctk->...ck", gout[..., 0, :], wins[0]) + torch.einsum(
        "...t,...ctk->...ck", gout[..., 1, :], wins[1])

    return dict(loss=loss, gw=gw[..., None, :, :], gh=gh, q=q, out=out)


def vae_siso_loss_and_grad_plain(w, h, x, amps, amp_mean: float, var: float, P,
                                 eps: float = EPS_KL):
    """Plain version of kernel F: (loss, gw, gh, q (..., 2n, N), out)."""
    st = siso_step_plain(w, h, x, amps, amp_mean, var, P, eps)
    return st["loss"], st["gw"], st["gh"], st["q"].flatten(-3, -2), st["out"]


def vae_siso_loss_and_grad(w, h, x, amps, amp_mean: float, var: float, P):
    """Kernel F. w (R, 1, 2, M), h (R, 2, M), x (R, 2, 2N) -> (loss (R), gw,
    gh, q (R, 2n, N), out (R, 2, N)), all R runs in one launch. CPU tensors
    take the plain version (any leading dims)."""
    if not x.is_cuda:
        return vae_siso_loss_and_grad_plain(w, h, x, amps, amp_mean, var, P)
    return _launch(w, h, x, amps, amp_mean, var, P)


def siso_step_clocks(w, h, x, amps, amp_mean: float, var: float, P) -> dict:
    """Kernel F once on CUDA tensors (the arguments of ``vae_siso_loss_and_grad``)
    with its phase clocks: {phase: clock64() cycles} of run 0's block. For
    measurement only (chip_smoke.py, tools/); the runners never ask for it."""
    clocks = torch.zeros(len(SISO_CLOCK_PHASES), dtype=torch.int64, device=x.device)
    _launch(w, h, x, amps, amp_mean, var, P, clocks)
    return dict(zip(SISO_CLOCK_PHASES, map(float, clocks.tolist())))


def _launch(w, h, x, amps, amp_mean: float, var: float, P, clocks=None):
    """Check the arguments, allocate the outputs and launch kernel F."""
    dev = x.device
    R, m, n_samp = x.shape[0], w.shape[-1], x.shape[-1]
    n_sym = n_samp // 2
    n_lev = amps.shape[0]
    if m % 2 != 1 or n_samp % 2 != 0:
        raise ValueError("kernel F needs odd M and an even sample count (sps = 2)")
    for name, t, shape in (("w", w, (R, 1, 2, m)), ("h", h, (R, 2, m)), ("x", x, (R, 2, n_samp)),
                           ("amps", amps, (n_lev,)), ("P", P, (n_lev,))):
        _build.check_tensor(name, t, shape, dev)
    lib = _build.load()
    f32 = dict(dtype=torch.float32, device=dev)
    loss = torch.empty(R, **f32)
    gw = torch.empty((R, 1, 2, m), **f32)
    gh = torch.empty((R, 2, m), **f32)
    q = torch.empty((R, 2 * n_lev, n_sym), **f32)
    out = torch.empty((R, 2, n_sym), **f32)
    rc = lib.vae_siso_step_launch(
        R, n_sym, m, n_lev, *(t.data_ptr() for t in (x, w, h, amps, P)), float(amp_mean),
        float(var), *(t.data_ptr() for t in (loss, gw, gh, q, out)),
        None if clocks is None else clocks.data_ptr(), _build.stream(dev))
    _build.check(rc, "vae_siso_step_launch")
    vae_siso_loss_and_grad.launches += 1
    return loss, gw, gh, q, out


vae_siso_loss_and_grad.launches = 0
