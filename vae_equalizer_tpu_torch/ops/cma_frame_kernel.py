"""Kernel D: the CMAbatch / CMAflex chunk engine over a frame, R runs.

Replaces the TPU kernel ``vae_equalizer_tpu/ops/cma_frame_kernel.py:
cma_chunked_frame_pallas`` (pallas_call at :212) and its runs-batched form
``cma_chunked_frame_pallas_rb`` (:404). The engine (``models.cma.
_cma_chunked``) adapts the 2x2 butterfly taps every ``symb_step`` = S
symbols from the increments of the last ``batch_len`` = B symbols: per
chunk, the symbol at the update point with the old taps; taps += 2 lr *
(sum of a ring of B/S per-chunk partial sums); the other S-1 symbols with
the new taps; the chunk's partial sums sum_t e_t inc_t into the ring.

On the card (``csrc/cma_kernels.cu`` + ``cma_step.cuh``): the whole frame in
one launch, one 512-thread block per run. The prefix [0, j0) with the
initial taps seeds the ring in the kernel; each chunk is two barrier
intervals (the S outputs up to the next update point with lane-split dot
products; the chunk's partial sums with the ring sum and the tap update by
the thread that owns each tap entry); the tail's last update and outputs
follow; out and e are written in the reference's rolled storage order. The
window span of the next chunk arrives by cp.async while this one runs. The
JAX wrapper's XLA-side prefix and tail (:191-196, :243-250), the TPU
kernel's (4M, n_full S) im2col and its HARR arrangement for the matrix unit
are not carried over. ``cma_chunked_clocks`` runs the kernel once with its
block's per-phase clock64() cycles (measurement only).

Dispatch: CPU tensors take ``cma_chunked_frame_plain`` (``models.cma.
_cma_chunked``, batched over the runs axis); CUDA tensors launch the kernel
or raise.
"""

from __future__ import annotations

import torch

from ..models.cma import _cma_chunked, _normalize_dp, chunk_schedule
from . import _build

__all__ = ["D_CLOCK_PHASES", "cma_chunked_clocks", "cma_chunked_frame", "cma_chunked_frame_plain"]

# kernel D's phases, in the order of csrc/cma_step.cuh: enum DPhase
D_CLOCK_PHASES = ("prefix", "next tile copies", "outputs", "outputs barrier", "partials",
                  "partials barrier", "update", "tile wait", "update barrier", "tail")


def cma_chunked_frame_plain(rx, R: float, h, lr, batch_len: int, symb_step: int, sps: int):
    """Plain version of kernel D: ``models.cma._cma_chunked`` (update=True)."""
    return _cma_chunked(rx, R, h, lr, batch_len, symb_step, sps, True)


def cma_chunked_frame(rx, R: float, h, lr, batch_len: int, symb_step: int, sps: int):
    """CMAbatch (S == B) / CMAflex (S < B) over a frame. Kernel D on a CUDA
    ``rx``, plain on the CPU.

    rx (runs, 2, 2, N) or (2, 2, N); h (runs, 2, 2, 2, M) or (2, 2, 2, M);
    B a multiple of S; lr a float or a one-element float32 tensor on rx's
    device (``cma_dp_kernel``). Returns (out (runs?, 2, 2, N//sps), h, e
    (runs?, N//sps, 2)) with the reference's storage roll.
    """
    if not rx.is_cuda:
        return cma_chunked_frame_plain(rx, R, h, lr, batch_len, symb_step, sps)
    if rx.dim() == 3:
        out, h, e = cma_chunked_frame(rx[None], R, h[None], lr, batch_len, symb_step, sps)
        return out[0], h[0], e[0]
    return _launch(rx, R, h, lr, batch_len, symb_step, sps)


def cma_chunked_clocks(rx, R: float, h, lr, batch_len: int, symb_step: int, sps: int) -> dict:
    """Kernel D once on CUDA tensors (the arguments of ``cma_chunked_frame``,
    with a runs axis) with its phase clocks: {phase: clock64() cycles per
    chunk} of run 0's thread 0, the frame's cycles over its full chunks. For
    measurement only (chip_smoke.py, tools/); the runners never ask for it."""
    clocks = torch.zeros(len(D_CLOCK_PHASES), dtype=torch.int64, device=rx.device)
    _launch(rx, R, h, lr, batch_len, symb_step, sps, clocks)
    n_full = chunk_schedule(rx.shape[-1] // sps, batch_len, symb_step, h.shape[-1] // 2, sps)[1]
    return {k: c / max(n_full, 1) for k, c in zip(D_CLOCK_PHASES, clocks.tolist())}


def _launch(rx, R: float, h, lr, batch_len: int, symb_step: int, sps: int, clocks=None):
    B, S = batch_len, symb_step
    if B % S != 0:
        raise ValueError(f"batch_len={B} must be a multiple of symb_step={S}")
    dev = rx.device
    runs, m = rx.shape[0], h.shape[-1]
    mh = m // 2
    n_sym = rx.shape[-1] // sps
    j0, n_full, tail = chunk_schedule(n_sym, B, S, mh, sps)
    y = _normalize_dp(rx, mh).contiguous()
    lp = y.shape[-1]
    for name, t, shape in (("y", y, (runs, 2, 2, lp)), ("h", h, (runs, 2, 2, 2, m))):
        _build.check_tensor(name, t, shape, dev)
    lib = _build.load()
    h_out = torch.empty_like(h)
    out = torch.empty((runs, 2, 2, n_sym), dtype=torch.float32, device=dev)
    e = torch.empty((runs, n_sym, 2), dtype=torch.float32, device=dev)
    lr = _build.device_scalar("lr", lr, torch.float32, dev)
    rc = lib.cma_chunked_launch(runs, n_sym, m, sps, lp, j0, S, n_full, B // S, tail, y.data_ptr(),
                                h.data_ptr(), h_out.data_ptr(), out.data_ptr(), e.data_ptr(),
                                float(R), lr.data_ptr(), None if clocks is None else clocks.data_ptr(),
                                _build.stream(dev))
    _build.check(rc, "cma_chunked_launch")
    cma_chunked_frame.launches += 1
    return out, h_out, e


_build.counted(cma_chunked_frame)
