"""Kernel C: the per-symbol 2x2 butterfly CMA recurrence over a frame, R runs.

Replaces the TPU kernel ``vae_equalizer_tpu/ops/cma_kernel.py:
cma_dp_pallas`` (pallas_call at :128), which the JAX experiment vmaps over
runs. Per symbol: the 4 butterfly outputs, the per-pol error R - |o|^2 and
the 8 tap-bank updates; the taps feed back into the next symbol. Numerics
and the reference's output storage roll match ``models.cma.cma_dp``.

On the card (``csrc/cma_kernels.cu`` + ``cma_step.cuh``): one warp per run,
each lane owning one tap (M <= 32; two up to 64) of all 8 rows in registers,
its o_re / o_im closed before a 32-lane shuffle butterfly in a fixed order
(4 trees), the normalized padded signal read from device memory through L1
a symbol ahead. A frame is ~10^4 dependent symbol steps, so a launch is bound
by that latency chain. The TPU's 256-lane block loads, lane rolls and
one-hot output tiles were Mosaic workarounds and are not carried over.
``cma_dp_clocks`` runs the kernel once with lane 0's per-phase clock64()
cycles (measurement only).

Dispatch: CPU tensors take ``cma_dp_plain`` (``models.cma.cma_dp``, a
Python loop over symbols, batched over the runs axis); CUDA tensors launch
the kernel or raise.
"""

from __future__ import annotations

import torch

from ..models.cma import _normalize_dp, cma_dp
from . import _build

__all__ = ["C_CLOCK_PHASES", "cma_dp_clocks", "cma_dp_kernel", "cma_dp_plain"]

# kernel C's per-symbol phases, in the order of csrc/cma_step.cuh: enum CPhase
C_CLOCK_PHASES = ("dot", "reduction", "error+store", "update", "next window")


def cma_dp_plain(rx, R: float, h, lr, sps: int, update: bool = True):
    """Plain version of kernel C: ``models.cma.cma_dp`` over the runs axis."""
    return cma_dp(rx, R, h, lr, sps, update)


def cma_dp_kernel(rx, R: float, h, lr, sps: int, update: bool = True):
    """Per-symbol CMA of a frame. Kernel C on a CUDA ``rx``, plain on the CPU.

    rx (runs, 2, 2, N) or (2, 2, N); h (runs, 2, 2, 2, M) or (2, 2, 2, M);
    R the CMA modulus; lr a float, or a one-element float32 tensor on rx's
    device (how a CUDA graph feeds each frame its rate). Returns (out (runs?,
    2, 2, N//sps), h, e (runs?, N//sps, 2)) with the reference's storage roll.
    """
    if not rx.is_cuda:
        return cma_dp_plain(rx, R, h, lr, sps, update)
    if rx.dim() == 3:
        out, h, e = cma_dp_kernel(rx[None], R, h[None], lr, sps, update)
        return out[0], h[0], e[0]
    return _launch(rx, R, h, lr, sps, update)


def cma_dp_clocks(rx, R: float, h, lr, sps: int, update: bool = True) -> dict:
    """Kernel C once on CUDA tensors (the arguments of ``cma_dp_kernel``, with
    a runs axis) with its phase clocks: {phase: clock64() cycles per symbol}
    of run 0's lane 0. For measurement only (chip_smoke.py, tools/); the
    runners never ask for it."""
    clocks = torch.zeros(len(C_CLOCK_PHASES), dtype=torch.int64, device=rx.device)
    _launch(rx, R, h, lr, sps, update, clocks)
    n_sym = rx.shape[-1] // sps
    return {k: c / n_sym for k, c in zip(C_CLOCK_PHASES, clocks.tolist())}


def _launch(rx, R: float, h, lr, sps: int, update: bool, clocks=None):
    dev = rx.device
    runs, m = rx.shape[0], h.shape[-1]
    n_sym = rx.shape[-1] // sps
    y = _normalize_dp(rx, m // 2).contiguous()
    lp = y.shape[-1]
    for name, t, shape in (("y", y, (runs, 2, 2, lp)), ("h", h, (runs, 2, 2, 2, m))):
        _build.check_tensor(name, t, shape, dev)
    lib = _build.load()
    h_out = torch.empty_like(h)
    out = torch.empty((runs, 2, 2, n_sym), dtype=torch.float32, device=dev)
    e = torch.empty((runs, n_sym, 2), dtype=torch.float32, device=dev)
    lr = _build.device_scalar("lr", lr, torch.float32, dev)
    rc = lib.cma_dp_launch(runs, n_sym, m, sps, lp, y.data_ptr(), h.data_ptr(), h_out.data_ptr(),
                           out.data_ptr(), e.data_ptr(), float(R), lr.data_ptr(), int(update),
                           None if clocks is None else clocks.data_ptr(), _build.stream(dev))
    _build.check(rc, "cma_dp_launch")
    cma_dp_kernel.launches += 1
    return out, h_out, e


_build.counted(cma_dp_kernel)
