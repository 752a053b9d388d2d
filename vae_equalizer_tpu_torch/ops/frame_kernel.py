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

Run constants (JAX ``frame_kernel.py:767-826, 902-913``): ``lr``, ``var``,
``nu_sc`` and ``P`` are each either shared by all runs (a float, (2,), a
float, (n,)) or given per run ((R,), (R, 2), (R,), (R, n)): run r trains
with lr[r] (w's lr still halves once at ``lr_half_step``), demaps with
var[r] and nu_sc[r] a^2, and holds its KL against P[r]. This is how a sweep
folds the points of its lr, SNR or nu axis into the runs of one launch. The
wrapper broadcasts the shared form into the per-run buffers the kernel
reads, so the card has one code path; a shared value and a constant
per-run vector give the same bits.

``stream_bf16`` stores the out, dec and eq streams as bfloat16 (rounded to
nearest even from the float32 values; dec's level indices are exact), and
training is unchanged. Unlike JAX (``frame_kernel.py:1011-1020``), mm and s1
stay float32: the MI rebuilds log-posteriors from them, and bfloat16 there
widens its error (the JAX package's own note at ``metrics/mi.py:338``).

On the card (``csrc/dp_kernels.cu``): grid = R, one 512-thread block per
run; the minibatch loop runs inside the block with w, h and the four Adam
moments resident in shared memory for the whole frame; the next window's
samples are loaded from ``rx`` while a step runs. A frame is 100 (990 with
VAEflex's stride 10) dependent steps, so it is bound by the step's latency
chain (``csrc/dp_step.cuh``: seven barrier-separated phases of ~400 items,
each item a serial chain), and R runs fill only R of the card's 132 SMs
(R = 8 uses 8).
The TPU design (im2col on the MXU, parity-major h, host-streamed parity
rows, windows assembled by a reshape, selection-matrix demapper) answered
Mosaic's constraints and is not carried over. ``frame_clocks`` runs it once
with the block's per-phase clock64() cycles (measurement only).

Dispatch: CPU tensors take ``vae_dp_frame_train_plain`` (a Python loop of
kernel A's plain step plus ``adam_update``); CUDA tensors launch the kernel
or raise. The q stream is not emitted (the JAX path runs with
emit_q=False), so the return drops JAX's q slot.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .elbo_kernel import dp_step_plain

__all__ = ["CLOCK_PHASES", "adam_schedule", "adam_update", "frame_clocks", "frame_opt_init",
           "vae_dp_frame_train", "vae_dp_frame_train_plain"]

# kernel B's step phases, in the order of csrc/dp_step.cuh: enum Phase
CLOCK_PHASES = ("forward", "demap", "D/S/C", "scalars", "gout", "gw/gh", "Adam/streams/x")

_B1 = 0.9
_B2 = 0.999
_EPS_ADAM = 1e-8


def frame_opt_init(params: dict) -> dict:
    """Zero Adam moments {"mw","vw","mh","vh"} in the shapes of w / h."""
    return {
        "mw": torch.zeros_like(params["w"]), "vw": torch.zeros_like(params["w"]),
        "mh": torch.zeros_like(params["h"]), "vh": torch.zeros_like(params["h"]),
    }


def adam_schedule(n_steps: int, lr_half_step: float, device) -> torch.Tensor:
    """Adam's per-step scalars of global steps 0 .. n_steps - 1 as a float32
    table (n_steps, 3) on ``device``: the bias corrections 1 - b1^t and
    1 - b2^t (t = step + 1) and w's lr factor (0.5 from ``lr_half_step`` on,
    else 1), each folded in float64 on the host as ``adam_update`` folds an
    int step, then rounded to float32. Row ``step`` is that step's device
    form: a CUDA graph reads it by a step count on the card, where an int
    step would be frozen into the capture."""
    rows = [(1.0 - _B1 ** (s + 1), 1.0 - _B2 ** (s + 1), 0.5 if s >= lr_half_step else 1.0)
            for s in range(n_steps)]
    return torch.tensor(rows, dtype=torch.float32, device=device)


def adam_update(params: dict, opt: dict, grads: dict, lr, step,
                lr_half_step: float = float("inf")) -> tuple[dict, dict]:
    """One Adam update of {"w", "h"} at global step ``step`` with optax
    semantics (b1 .9, b2 .999, eps 1e-8 outside the sqrt, bias correction
    with t = step + 1); w's lr halves once ``step`` reaches ``lr_half_step``,
    h keeps the base lr (JAX ``train/dp.py: _vae_optimizer``). ``step`` is an
    int, or its row (3,) of ``adam_schedule`` (whose table already holds the
    halving; ``lr_half_step`` is then unused). ``lr`` is a float, or a float32
    tensor (R,) of per-run rates over the params' leading runs axis. Moments
    {"mw","vw","mh","vh"} as ``frame_opt_init``. Returns (params', opt')."""
    if torch.is_tensor(step):
        bc1, bc2, half = step.unbind(-1)
        lr_w = lr * half
    else:
        bc1 = 1.0 - _B1 ** (step + 1)
        bc2 = 1.0 - _B2 ** (step + 1)
        lr_w = lr * (0.5 if step >= lr_half_step else 1.0)
    new_p, new_o = {}, {}
    for k, lr_k in (("w", lr_w), ("h", lr)):
        if torch.is_tensor(lr_k):  # per run: over the leading runs axis
            lr_k = lr_k.reshape(lr_k.shape + (1,) * (params[k].dim() - lr_k.dim()))
        mo = _B1 * opt["m" + k] + (1 - _B1) * grads[k]
        ve = _B2 * opt["v" + k] + (1 - _B2) * grads[k] * grads[k]
        new_p[k] = params[k] - lr_k * ((mo / bc1) / (torch.sqrt(ve / bc2) + _EPS_ADAM))
        new_o["m" + k], new_o["v" + k] = mo, ve
    return new_p, {k: new_o[k] for k in ("mw", "vw", "mh", "vh")}


def _shape(v) -> tuple:
    return tuple(v.shape) if torch.is_tensor(v) else np.shape(v)


def _check_run_consts(R: int, lr, var, nu_sc, P) -> None:
    """The per-run forms must have R rows (JAX's checks and messages,
    ``frame_kernel.py:772-773, 798-801, 843-846, 903-904``)."""
    if len(_shape(var)) == 2 and _shape(var) != (R, 2):
        raise ValueError(f"per-run var must be ({R}, 2), got {_shape(var)}")
    if len(_shape(nu_sc)) > 0 and _shape(nu_sc) != (R,):
        raise ValueError(f"per-run nu_sc must have shape ({R},), got {_shape(nu_sc)}")
    if len(_shape(P)) == 2 and _shape(P)[0] != R:
        raise ValueError(f"per-run P must have leading dim {R}, got {_shape(P)}")
    if len(_shape(lr)) > 0 and _shape(lr) != (R,):
        raise ValueError(f"per-run lr must have shape ({R},), got {_shape(lr)}")


def _windows(n_total: int, bl_sym: int, stride_sym: int | None) -> tuple[int, int]:
    """(number of minibatch windows, window stride in symbols) of a frame of
    ``n_total`` samples (JAX ``frame_kernel.py:701-717``)."""
    if stride_sym is None or stride_sym == bl_sym:
        return n_total // (2 * bl_sym), bl_sym
    if stride_sym < 1 or bl_sym % stride_sym != 0:
        raise ValueError(f"the window length bl_sym={bl_sym} must be a multiple of the stride "
                         f"stride_sym={stride_sym}")
    return (n_total // 2 - bl_sym) // stride_sym, stride_sym


def vae_dp_frame_train_plain(w, h, opt, rx, amps, var, nu_sc, P, lr, step0,
                             lr_half_step: float, *, bl_sym: int, stride_sym: int | None = None,
                             stream_bf16: bool = False):
    """Plain version of kernel B (same arguments and returns as
    ``vae_dp_frame_train``)."""
    _check_run_consts(w.shape[0], lr, var, nu_sc, P)
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
    sdt, ddt = (torch.bfloat16, torch.bfloat16) if stream_bf16 else (torch.float32, torch.int32)
    return (params["w"], params["h"], opt, s["loss"], s["var_est"], s["out"].to(sdt),
            s["dec"].to(ddt), s["eq"][..., 0, :].to(sdt), s["mm"], s["s1"])


def vae_dp_frame_train(w, h, opt, rx, amps, var, nu_sc, P, lr, step0,
                       lr_half_step: float, *, bl_sym: int, stride_sym: int | None = None,
                       stream_bf16: bool = False):
    """Train one frame of R runs. Kernel B on a CUDA ``rx``, plain on the CPU.

    w (R, 2, 4, M); h (R, 2, 2, 2, M); opt {"mw","vw","mh","vh"} in those
    shapes; rx (R, 2, 2, Nsamp); amps (n,); the run constants shared or per
    run (module docstring): lr a float or (R,), var (2,) or (R, 2), nu_sc a
    float or (R,), P (n,) or (R, n), tensors on rx's device; step0 = global
    step of the frame's first minibatch, an int or a one-element int64
    tensor on rx's device (the kernel reads it from device memory, so a
    launch captured in a CUDA graph takes each replay's step from the
    counter the graph advances). Minibatches: m_max = Nsamp // (2
    bl_sym) back-to-back windows, or with ``stride_sym`` (a divisor of
    bl_sym; VAEflex) m_max = (Nsamp / 2 - bl_sym) // stride_sym windows of
    bl_sym symbols starting every stride_sym symbols.

    Returns (w', h', opt', losses (m_max, R), var_est (m_max, R, 2),
    out (m_max, R, 2, 2, bl), dec (m_max, R, 2, 2, bl) argmax level (int32),
    eq (m_max, R, 2, bl) E_q[x^I], mm / s1 (m_max, R, 2, 2, bl) the softmin
    minimum and normalizer) — the JAX returns without the q slot. With
    ``stream_bf16`` out, dec and eq are bfloat16.
    """
    if not rx.is_cuda:
        return vae_dp_frame_train_plain(w, h, opt, rx, amps, var, nu_sc, P, lr, step0,
                                        lr_half_step, bl_sym=bl_sym, stride_sym=stride_sym,
                                        stream_bf16=stream_bf16)
    return _launch(w, h, opt, rx, amps, var, nu_sc, P, lr, step0, lr_half_step, bl_sym, stride_sym,
                   stream_bf16)


def _per_run(name: str, v, R: int, tail: tuple, dev) -> torch.Tensor:
    """A run constant as the contiguous float32 (R, *tail) buffer kernel B
    reads; the shared form (a float, or a tensor of shape ``tail``) is
    broadcast to every run."""
    if not torch.is_tensor(v):
        if np.ndim(v) == 0:
            return torch.full((R,) + tail, float(v), dtype=torch.float32, device=dev)
        raise ValueError(f"{name}: a float or a float32 tensor on {dev}, got {type(v).__name__}")
    if tuple(v.shape) == tail:
        v = v.expand((R,) + tail).contiguous()
    _build.check_tensor(name, v, (R,) + tail, dev)
    return v


def frame_clocks(w, h, opt, rx, amps, var, nu_sc, P, lr, step0: int, lr_half_step: float, *,
                 bl_sym: int, stride_sym: int | None = None) -> dict:
    """Kernel B once on CUDA tensors (the arguments of ``vae_dp_frame_train``)
    with its phase clocks: {phase: clock64() cycles per step} of run 0's
    block, averaged over the frame's steps. For measurement only (chip_smoke.py,
    tools/); the runners never ask for it."""
    clocks = torch.zeros(len(CLOCK_PHASES), dtype=torch.int64, device=rx.device)
    res = _launch(w, h, opt, rx, amps, var, nu_sc, P, lr, step0, lr_half_step, bl_sym, stride_sym,
                  False, clocks)
    steps = res[3].shape[0]
    return {k: c / steps for k, c in zip(CLOCK_PHASES, clocks.tolist())}


def _launch(w, h, opt, rx, amps, var, nu_sc, P, lr, step0, lr_half_step, bl_sym, stride_sym,
            stream_bf16, clocks=None):
    dev = rx.device
    R, m = w.shape[0], w.shape[-1]
    n_lev = amps.shape[0]
    n_total = rx.shape[-1]
    n_sym = bl_sym
    m_max, fs = _windows(n_total, bl_sym, stride_sym)
    _check_run_consts(R, lr, var, nu_sc, P)
    checks = [("rx", rx, (R, 2, 2, n_total)), ("w", w, (R, 2, 4, m)), ("h", h, (R, 2, 2, 2, m)),
              ("amps", amps, (n_lev,))]
    checks += [(k, opt[k], w.shape if k[1] == "w" else h.shape) for k in ("mw", "vw", "mh", "vh")]
    for name, t, shape in checks:
        _build.check_tensor(name, t, shape, dev)
    consts = (_per_run("P", P, R, (n_lev,), dev), _per_run("var", var, R, (2,), dev),
              _per_run("nu_sc", nu_sc, R, (), dev), _per_run("lr", lr, R, (), dev))
    step0 = _build.device_scalar("step0", step0, torch.int64, dev)
    lib = _build.load()
    f32 = dict(dtype=torch.float32, device=dev)
    sdt, ddt = (torch.bfloat16, torch.bfloat16) if stream_bf16 else (torch.float32, torch.int32)
    new = {k: torch.empty_like(t) for k, t in (("w", w), ("h", h), *opt.items())}
    losses = torch.empty((m_max, R), **f32)
    var_est = torch.empty((m_max, R, 2), **f32)
    out = torch.empty((m_max, R, 2, 2, n_sym), dtype=sdt, device=dev)
    dec = torch.empty((m_max, R, 2, 2, n_sym), dtype=ddt, device=dev)
    eq = torch.empty((m_max, R, 2, n_sym), dtype=sdt, device=dev)
    mm = torch.empty((m_max, R, 2, 2, n_sym), **f32)
    s1 = torch.empty((m_max, R, 2, 2, n_sym), **f32)
    ins = (rx, w, h, opt["mw"], opt["vw"], opt["mh"], opt["vh"])
    outs = (new["w"], new["h"], new["mw"], new["vw"], new["mh"], new["vh"], losses, var_est, out,
            dec, eq, mm, s1)
    rc = lib.vae_dp_frame_launch(
        R, m_max, n_sym, fs, m, n_lev, n_total, *(t.data_ptr() for t in ins + outs), amps.data_ptr(),
        *(t.data_ptr() for t in consts), step0.data_ptr(), float(lr_half_step), int(bool(stream_bf16)),
        None if clocks is None else clocks.data_ptr(), _build.stream(dev))
    _build.check(rc, "vae_dp_frame_launch")
    vae_dp_frame_train.launches += 1
    opt_new = {k: new[k] for k in ("mw", "vw", "mh", "vh")}
    return new["w"], new["h"], opt_new, losses, var_est, out, dec, eq, mm, s1


_build.counted(vae_dp_frame_train)
