"""Kernel B: one frame of DP VAE online training for R runs, in one launch.

Replaces the TPU kernel ``vae_equalizer_tpu/ops/frame_kernel.py:
vae_dp_frame_train_pallas_rb`` (pallas_call at :1024). For each of the
frame's m_max minibatches in sequence: butterfly -> PCS softmin demapper ->
DP ELBO -> closed-form backward (kernel A's step, ``ops/elbo_kernel.py``) ->
Adam with optax semantics (b1 .9, b2 .999, eps 1e-8 outside the sqrt, bias
correction with t = step + 1; w's lr halves once the global step reaches
``lr_half_step``, h keeps the base lr — train/dp.py:_vae_optimizer). It
also emits the eval streams out, dec, eq, mm, s1.

With ``stride_sym`` (VAEflex) minibatch mb is the window of bl symbols
starting at symbol mb * stride_sym, and a frame of N symbols has
(N - bl) // stride_sym windows (JAX ``frame_kernel.py:701-717``).

On the card (``csrc/dp_kernels.cu``): grid = R, one 256-thread block per
run; the minibatch loop runs inside the block with w, h and the four Adam
moments resident in shared memory for the whole frame, each minibatch read
straight from ``rx`` in device memory at its window's offset. A frame is
100 (990 with VAEflex's stride 10) dependent steps of ~10 dependent phases
each, so it is bound by that latency chain, and R runs fill only R of the
card's 132 SMs (R = 8 uses 8). The TPU design (im2col on the MXU,
parity-major h, host-streamed parity rows, windows assembled by a reshape,
selection-matrix demapper) answered Mosaic's constraints and is not
carried over.

Dispatch: CPU tensors take ``vae_dp_frame_train_plain`` (a Python loop of
kernel A's plain step plus ``adam_update``); CUDA tensors launch the kernel
or raise. The q stream is not emitted (the JAX path runs with
emit_q=False), so the return drops JAX's q slot.
"""

from __future__ import annotations

import torch

from . import _build
from .elbo_kernel import dp_step_plain

__all__ = ["adam_update", "frame_opt_init", "vae_dp_frame_train", "vae_dp_frame_train_plain"]

_B1 = 0.9
_B2 = 0.999
_EPS_ADAM = 1e-8


def frame_opt_init(params: dict) -> dict:
    """Zero Adam moments {"mw","vw","mh","vh"} in the shapes of w / h."""
    return {
        "mw": torch.zeros_like(params["w"]), "vw": torch.zeros_like(params["w"]),
        "mh": torch.zeros_like(params["h"]), "vh": torch.zeros_like(params["h"]),
    }


def adam_update(params: dict, opt: dict, grads: dict, lr: float, step: int,
                lr_half_step: float = float("inf")) -> tuple[dict, dict]:
    """One Adam update of {"w", "h"} at global step ``step`` with optax
    semantics (b1 .9, b2 .999, eps 1e-8 outside the sqrt, bias correction
    with t = step + 1); w's lr halves once ``step`` reaches ``lr_half_step``,
    h keeps the base lr (JAX ``train/dp.py: _vae_optimizer``). Moments
    {"mw","vw","mh","vh"} as ``frame_opt_init``. Returns (params', opt')."""
    bc1 = 1.0 - _B1 ** (step + 1)
    bc2 = 1.0 - _B2 ** (step + 1)
    lr_w = lr * (0.5 if step >= lr_half_step else 1.0)
    new_p, new_o = {}, {}
    for k, lr_k in (("w", lr_w), ("h", lr)):
        mo = _B1 * opt["m" + k] + (1 - _B1) * grads[k]
        ve = _B2 * opt["v" + k] + (1 - _B2) * grads[k] * grads[k]
        new_p[k] = params[k] - lr_k * ((mo / bc1) / (torch.sqrt(ve / bc2) + _EPS_ADAM))
        new_o["m" + k], new_o["v" + k] = mo, ve
    return new_p, {k: new_o[k] for k in ("mw", "vw", "mh", "vh")}


def _windows(n_total: int, bl_sym: int, stride_sym: int | None) -> tuple[int, int]:
    """(number of minibatch windows, window stride in symbols) of a frame of
    ``n_total`` samples (JAX ``frame_kernel.py:701-717``)."""
    if stride_sym is None or stride_sym == bl_sym:
        return n_total // (2 * bl_sym), bl_sym
    if stride_sym < 1 or bl_sym % stride_sym != 0:
        raise ValueError(f"the window length bl_sym={bl_sym} must be a multiple of the stride "
                         f"stride_sym={stride_sym}")
    return (n_total // 2 - bl_sym) // stride_sym, stride_sym


def vae_dp_frame_train_plain(w, h, opt, rx, amps, var, nu_sc: float, P, lr: float, step0: int,
                             lr_half_step: float, *, bl_sym: int, stride_sym: int | None = None):
    """Plain version of kernel B (same arguments and returns as
    ``vae_dp_frame_train``)."""
    m_max, fs = _windows(rx.shape[-1], bl_sym, stride_sym)
    params = {"w": w, "h": h}
    streams = {k: [] for k in ("loss", "var_est", "out", "dec", "eq", "mm", "s1")}
    for mb in range(m_max):
        st = dp_step_plain(params["w"], params["h"], rx[..., 2 * fs * mb : 2 * (fs * mb + bl_sym)],
                           amps, var, nu_sc, P)
        for k in streams:
            streams[k].append(st[k])
        params, opt = adam_update(params, opt, {"w": st["gw"], "h": st["gh"]}, lr, int(step0) + mb,
                                  lr_half_step)
    s = {k: torch.stack(v) for k, v in streams.items()}
    return (params["w"], params["h"], opt, s["loss"], s["var_est"], s["out"],
            s["dec"].to(torch.int32), s["eq"][..., 0, :], s["mm"], s["s1"])


def vae_dp_frame_train(w, h, opt, rx, amps, var, nu_sc: float, P, lr: float, step0: int,
                       lr_half_step: float, *, bl_sym: int, stride_sym: int | None = None):
    """Train one frame of R runs. Kernel B on a CUDA ``rx``, plain on the CPU.

    w (R, 2, 4, M); h (R, 2, 2, 2, M); opt {"mw","vw","mh","vh"} in those
    shapes; rx (R, 2, 2, Nsamp); amps/P (n,); var (2,); step0 = global step
    of the frame's first minibatch. Minibatches: m_max = Nsamp // (2 bl_sym)
    back-to-back windows, or with ``stride_sym`` (a divisor of bl_sym; VAEflex)
    m_max = (Nsamp / 2 - bl_sym) // stride_sym windows of bl_sym symbols
    starting every stride_sym symbols.

    Returns (w', h', opt', losses (m_max, R), var_est (m_max, R, 2),
    out (m_max, R, 2, 2, bl), dec (m_max, R, 2, 2, bl) int32 argmax level,
    eq (m_max, R, 2, bl) E_q[x^I], mm / s1 (m_max, R, 2, 2, bl) the softmin
    minimum and normalizer) — the JAX returns without the q slot.
    """
    if not rx.is_cuda:
        return vae_dp_frame_train_plain(w, h, opt, rx, amps, var, nu_sc, P, lr, step0,
                                        lr_half_step, bl_sym=bl_sym, stride_sym=stride_sym)
    return _launch(w, h, opt, rx, amps, var, nu_sc, P, lr, step0, lr_half_step, bl_sym, stride_sym)


def _launch(w, h, opt, rx, amps, var, nu_sc, P, lr, step0, lr_half_step, bl_sym, stride_sym):
    dev = rx.device
    R, m = w.shape[0], w.shape[-1]
    n_lev = amps.shape[0]
    n_total = rx.shape[-1]
    n_sym = bl_sym
    m_max, fs = _windows(n_total, bl_sym, stride_sym)
    checks = [("rx", rx, (R, 2, 2, n_total)), ("w", w, (R, 2, 4, m)), ("h", h, (R, 2, 2, 2, m)),
              ("amps", amps, (n_lev,)), ("P", P, (n_lev,)), ("var", var, (2,))]
    checks += [(k, opt[k], w.shape if k[1] == "w" else h.shape) for k in ("mw", "vw", "mh", "vh")]
    for name, t, shape in checks:
        _build.check_tensor(name, t, shape, dev)
    lib = _build.load()
    f32 = dict(dtype=torch.float32, device=dev)
    new = {k: torch.empty_like(t) for k, t in (("w", w), ("h", h), *opt.items())}
    losses = torch.empty((m_max, R), **f32)
    var_est = torch.empty((m_max, R, 2), **f32)
    out = torch.empty((m_max, R, 2, 2, n_sym), **f32)
    dec = torch.empty((m_max, R, 2, 2, n_sym), dtype=torch.int32, device=dev)
    eq = torch.empty((m_max, R, 2, n_sym), **f32)
    mm = torch.empty((m_max, R, 2, 2, n_sym), **f32)
    s1 = torch.empty((m_max, R, 2, 2, n_sym), **f32)
    ins = (rx, w, h, opt["mw"], opt["vw"], opt["mh"], opt["vh"])
    outs = (new["w"], new["h"], new["mw"], new["vw"], new["mh"], new["vh"], losses, var_est, out,
            dec, eq, mm, s1)
    rc = lib.vae_dp_frame_launch(
        R, m_max, n_sym, fs, m, n_lev, n_total, *(t.data_ptr() for t in ins + outs), amps.data_ptr(),
        P.data_ptr(), var.data_ptr(), nu_sc, lr, int(step0), float(lr_half_step),
        _build.stream(dev))
    _build.check(rc, "vae_dp_frame_launch")
    vae_dp_frame_train.launches += 1
    opt_new = {k: new[k] for k in ("mw", "vw", "mh", "vh")}
    return new["w"], new["h"], opt_new, losses, var_est, out, dec, eq, mm, s1


vae_dp_frame_train.launches = 0
