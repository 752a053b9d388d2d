"""Kernel K: the DP VAE frame's eval (sync, aligned SER and MI of all runs)
in one launch.

Replaces no TPU kernel: the JAX package evaluates a frame with plain jnp
(``vae_equalizer_tpu/train/dp.py:187-214``, the stats branch of
``_dp_frame_eval_mb``). Its plain PyTorch version here,
``train/dp.py: _dp_frame_eval_mb``, is ~590 small kernels a flagship frame
of 8 runs on the card: 1.2 ms of device time, ~30 ms of host launches to
capture, and most of the loop mode's launches. K takes kernel B's streams
as B wrote them, (m_max, R, ...), through their strides (VAEflex's central
crop is a view), and returns what the plain version returns: per run
ser_const, ser_soft and mi (R, 2), the E_q[x^I] sync's shift (R, 2) and r
(R,), with the same decisions, SERs and sync exactly and the MI to float32
rounding (``csrc/dp_eval_step.cuh`` says how, what bounds K and what its
design does about it).

It adapts to what it is given: out / eq float32 and dec int32, or all
three bfloat16 (``stream_bf16``); the eval constants P (n,) or (R, n), var
(2,) or (R, 2) and nu_sc a float or (R,), shared or per run; and the eval
mask, from ``weight_fn.kernel_mask()`` of the weight objects of
``train/eval_utils.py`` (``BatchCutWeight``, ``MarginWeight``).

The plain version lives in ``train/dp.py`` (its sync, SER and MI estimators
are ``metrics/``, a layer above ``ops/``), which calls this wrapper for CUDA
tensors only; the wrapper launches K or raises.
"""

from __future__ import annotations

import math

import torch

from . import _build

__all__ = ["CLOCK_PHASES", "MASK_KINDS", "SYNC_CORR_LEN", "eval_clocks", "vae_dp_frame_eval"]

# the sync searches' correlation window (train/dp.py:76 of the JAX package): a
# contiguous 2000-symbol prefix finds the global delay with a ~45:1 peak
# margin; the plain evals of train/dp.py use it too, and K's staging is sized
# for it (csrc/dp_eval_step.cuh: kMaxCorr)
SYNC_CORR_LEN = 2000
# the eval masks K computes, by the name a weight object's kernel_mask() gives,
# numbered as csrc/dp_eval_step.cuh: MaskKind numbers them
MASK_KINDS = ("batch_cut", "margin")

# kernel K's phases, in the order of csrc/dp_eval_kernel.cu (the waits are the
# cluster barriers)
CLOCK_PHASES = ("sync corr", "wait 1", "sync decide", "pass A", "wait 2", "pass B", "wait 3",
                "finish")


def _run_const(name: str, v, shared: tuple, R: int, dev):
    """A run constant as a contiguous float32 tensor of shape ``shared`` or
    (R, *shared) on ``dev``: (the tensor, its run stride, 0 where shared)."""
    per_run = (R,) + shared
    if (v.device != dev or v.dtype != torch.float32 or not v.is_contiguous()
            or tuple(v.shape) not in (shared, per_run)):
        raise ValueError(f"{name}: needs a contiguous float32 tensor {shared} or {per_run} on "
                         f"{dev}, got {tuple(v.shape)} {v.dtype} on {v.device}")
    return v, 0 if tuple(v.shape) == shared else math.prod(shared)


def vae_dp_frame_eval(out_mb, dec_mb, eq_mb, mm_mb, s1_mb, tx, amps, P, nu_sc, var, weight_fn):
    """Evaluate one frame of R runs from kernel B's streams. CUDA tensors only.

    out_mb, dec_mb, mm_mb, s1_mb (m_max, R, 2, 2, L) and eq_mb (m_max, R, 2,
    L), L the (cropped) window, as views of kernel B's outputs: out, dec, mm
    and s1 with one set of strides, each time axis of stride 1; out / eq
    float32 with dec int32, or all three bfloat16; mm, s1 float32. tx (R, 2,
    2, m_max L) float32 levels (time stride 1); amps (n,); P (n,) or (R, n);
    var (2,) or (R, 2); nu_sc a float or (R,); ``weight_fn`` a weight object
    with ``kernel_mask()``. The syncs correlate over SYNC_CORR_LEN symbols.
    Returns (ser_const, ser_soft, mi) (R, 2) float32 and (shift (R, 2), r
    (R,)) int32, as ``train/dp.py: _dp_frame_eval_mb``.
    """
    if not out_mb.is_cuda:
        raise ValueError("kernel K runs on CUDA tensors; the plain version is "
                         "train/dp.py: _dp_frame_eval_mb")
    return _launch(out_mb, dec_mb, eq_mb, mm_mb, s1_mb, tx, amps, P, nu_sc, var, weight_fn)


def eval_clocks(*args) -> dict:
    """Kernel K once on CUDA tensors (the arguments of ``vae_dp_frame_eval``)
    with its phase clocks: {phase: clock64() cycles} of block 0's thread 0.
    For measurement only (chip_smoke.py); the runners never ask for it."""
    clocks = torch.zeros(len(CLOCK_PHASES), dtype=torch.int64, device=args[0].device)
    _launch(*args, clocks)
    return dict(zip(CLOCK_PHASES, clocks.tolist()))


def _launch(out_mb, dec_mb, eq_mb, mm_mb, s1_mb, tx, amps, P, nu_sc, var, weight_fn, clocks=None):
    dev = out_mb.device
    m_max, R, _, _, L = out_mb.shape
    n_lev = amps.shape[0]
    bf16 = out_mb.dtype == torch.bfloat16
    dtypes = (torch.bfloat16,) * 3 if bf16 else (torch.float32, torch.int32, torch.float32)
    streams = (("out_mb", out_mb), ("dec_mb", dec_mb), ("mm_mb", mm_mb), ("s1_mb", s1_mb))
    if (out_mb.dtype, dec_mb.dtype, eq_mb.dtype) != dtypes or any(
            t.dtype != torch.float32 for t in (mm_mb, s1_mb)):
        raise ValueError("streams: out / eq float32 and dec int32, or all three bfloat16, with mm "
                         f"and s1 float32; got {out_mb.dtype} {dec_mb.dtype} {eq_mb.dtype} "
                         f"{mm_mb.dtype} {s1_mb.dtype}")
    for name, t in streams:
        if t.device != dev or tuple(t.shape) != (m_max, R, 2, 2, L) or t.stride() != out_mb.stride():
            raise ValueError(f"{name}: needs shape {(m_max, R, 2, 2, L)} and out_mb's strides "
                             f"on {dev}, got {tuple(t.shape)} {t.stride()} on {t.device}")
    if out_mb.stride(-1) != 1 or eq_mb.stride(-1) != 1 or tuple(eq_mb.shape) != (m_max, R, 2, L):
        raise ValueError(f"eq_mb: needs shape {(m_max, R, 2, L)}; every time axis stride 1")
    n = m_max * L
    if (tx.dtype != torch.float32 or tx.device != dev or tuple(tx.shape) != (R, 2, 2, n)
            or tx.stride(-1) != 1):
        raise ValueError(f"tx: needs a float32 tensor (R, 2, 2, {n}) of time stride 1 on {dev}, "
                         f"got {tuple(tx.shape)} {tx.dtype} on {tx.device}")
    if amps.dtype != torch.float32 or amps.device != dev or not amps.is_contiguous():
        raise ValueError(f"amps: needs a contiguous float32 tensor on {dev}")
    P, p_run = _run_const("P", P, (n_lev,), R, dev)
    var, v_run = _run_const("var", var, (2,), R, dev)
    nu_runs = None
    if torch.is_tensor(nu_sc):  # per run, or a float
        nu_runs, _ = _run_const("nu_sc", nu_sc, (), R, dev)
        if nu_runs.dim() == 0:
            raise ValueError(f"nu_sc: a float, or a float32 tensor ({R},) of one per run")
        nu_sc = 0.0
    kind, a, b, c, margin = weight_fn.kernel_mask()
    kind = MASK_KINDS.index(kind)
    res_f = torch.empty((R, 6), dtype=torch.float32, device=dev)
    res_i = torch.empty((R, 3), dtype=torch.int32, device=dev)
    lib = _build.load()
    rc = lib.vae_dp_eval_launch(
        R, m_max, L, n_lev, SYNC_CORR_LEN, int(bf16),
        *(t.data_ptr() for t in (out_mb, dec_mb, eq_mb, mm_mb, s1_mb)), *out_mb.stride()[:4],
        *eq_mb.stride()[:3], tx.data_ptr(), *tx.stride()[:3], amps.data_ptr(), P.data_ptr(), p_run,
        var.data_ptr(), v_run, float(nu_sc), None if nu_runs is None else nu_runs.data_ptr(),
        math.sqrt((n_lev**2 - 1) / 6), (n_lev - 1) / 2, kind, a, b, c, margin, res_f.data_ptr(),
        res_i.data_ptr(), None if clocks is None else clocks.data_ptr(), _build.stream(dev))
    _build.check(rc, "vae_dp_eval_launch")
    vae_dp_frame_eval.launches += 1
    return res_f[:, 0:2], res_f[:, 2:4], res_f[:, 4:6], res_i[:, 0:2], res_i[:, 2]


_build.counted(vae_dp_frame_eval)
