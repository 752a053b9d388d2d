"""Kernel D: the CMAbatch / CMAflex chunk engine over a frame, R runs.

Replaces the TPU kernel ``vae_equalizer_tpu/ops/cma_frame_kernel.py:
cma_chunked_frame_pallas`` (pallas_call at :212) and its runs-batched form
``cma_chunked_frame_pallas_rb`` (:404). The engine (``models.cma.
_cma_chunked``) adapts the 2x2 butterfly taps every ``symb_step`` = S
symbols from the increments of the last ``batch_len`` = B symbols. Every
full chunk of a frame runs in the kernel, per chunk: the symbol at the
update point with the old taps; taps += 2 lr * (sum of a ring of B/S
per-chunk partial sums); the other S-1 symbols with the new taps; the
chunk's partial sums sum_t e_t inc_t into the ring.

On the card (``csrc/cma_kernels.cu``): one block per run with the chunk loop
inside it, taps and ring resident in shared memory, windows read straight
from the normalized signal by index (the TPU kernel's (4M, n_full S) im2col
and its HARR arrangement for the matrix unit are not carried over). The
prefix [0, j0) with the initial taps and the tail after the last full chunk
run in plain PyTorch here, as the JAX wrapper does (:191-196, :243-250).

Dispatch: CPU tensors take ``cma_chunked_frame_plain`` (``models.cma.
_cma_chunked``, batched over the runs axis); CUDA tensors launch the kernel
or raise.
"""

from __future__ import annotations

import torch

from ..models.cma import (
    _cma_chunked,
    _increments,
    _normalize_dp,
    _roll_storage,
    _run_const,
    chunk_schedule,
)
from . import _build

__all__ = ["cma_chunked_frame", "cma_chunked_frame_plain"]


def cma_chunked_frame_plain(rx, R: float, h, lr, batch_len: int, symb_step: int, sps: int):
    """Plain version of kernel D: ``models.cma._cma_chunked`` (update=True)."""
    return _cma_chunked(rx, R, h, lr, batch_len, symb_step, sps, True)


def cma_chunked_frame(rx, R: float, h, lr, batch_len: int, symb_step: int, sps: int):
    """CMAbatch (S == B) / CMAflex (S < B) over a frame. Kernel D on a CUDA
    ``rx``, plain on the CPU.

    rx (runs, 2, 2, N) or (2, 2, N); h (runs, 2, 2, 2, M) or (2, 2, 2, M);
    B a multiple of S. Returns (out (runs?, 2, 2, N//sps), h, e (runs?,
    N//sps, 2)) with the reference's storage roll.
    """
    if not rx.is_cuda:
        return cma_chunked_frame_plain(rx, R, h, lr, batch_len, symb_step, sps)
    if rx.dim() == 3:
        out, h, e = cma_chunked_frame(rx[None], R, h[None], lr, batch_len, symb_step, sps)
        return out[0], h[0], e[0]
    return _launch(rx, R, h, lr, batch_len, symb_step, sps)


def _launch(rx, R: float, h, lr, batch_len: int, symb_step: int, sps: int):
    B, S = batch_len, symb_step
    if B % S != 0:
        raise ValueError(f"batch_len={B} must be a multiple of symb_step={S}")
    dev = rx.device
    runs, m = rx.shape[0], h.shape[-1]
    mh = m // 2
    n_sym = rx.shape[-1] // sps
    n_slots = B // S
    j0, n_full, tail = chunk_schedule(n_sym, B, S, mh, sps)
    y = _normalize_dp(rx, mh).contiguous()
    lp = y.shape[-1]
    for name, t, shape in (("y", y, (runs, 2, 2, lp)), ("h", h, (runs, 2, 2, 2, m))):
        _build.check_tensor(name, t, shape, dev)

    # prefix [0, j0): the initial taps; the ring starts from its last B symbols
    o_re_p, o_im_p, e_p, w_p = _run_const(y, 0, j0, h, R, m, sps)
    inc = _increments(w_p[:, j0 - B :], o_re_p[:, j0 - B :], o_im_p[:, j0 - B :])
    ring = torch.einsum("rjtx,rjtxvck->rjxvck", e_p[:, j0 - B :].unflatten(1, (n_slots, S)),
                        inc.unflatten(1, (n_slots, S))).contiguous()

    lib = _build.load()
    f32 = dict(dtype=torch.float32, device=dev)
    h_mid, ring_out = torch.empty_like(h), torch.empty_like(ring)
    out_c = torch.empty((runs, 2, 2, n_full * S), **f32)
    e_c = torch.empty((runs, 2, n_full * S), **f32)
    rc = lib.cma_chunked_launch(runs, m, sps, lp, j0, S, n_full, n_slots, y.data_ptr(),
                                h.data_ptr(), ring.data_ptr(), h_mid.data_ptr(),
                                ring_out.data_ptr(), out_c.data_ptr(), e_c.data_ptr(), float(R),
                                float(2 * lr), _build.stream(dev))
    _build.check(rc, "cma_chunked_launch")
    cma_chunked_frame.launches += 1

    # tail: the symbol at the last update point, one last update, `tail - 1` outputs
    k = j0 + n_full * S
    o_re0, o_im0, e0, _ = _run_const(y, k, 1, h_mid, R, m, sps)
    h_fin = h_mid + 2 * lr * ring_out.sum(dim=1)
    o_re_t, o_im_t, e_t, _ = _run_const(y, k + 1, tail - 1, h_fin, R, m, sps)

    chunk_re, chunk_im = out_c[:, :, 0].mT, out_c[:, :, 1].mT  # (runs, T, chi)
    cat = lambda *a: torch.cat(a, dim=-2)
    out, e = _roll_storage(cat(o_re_p, chunk_re, o_re0, o_re_t), cat(o_im_p, chunk_im, o_im0, o_im_t),
                           cat(e_p, e_c.mT, e0, e_t), mh - mh // sps)
    return out, h_fin, e


cma_chunked_frame.launches = 0
