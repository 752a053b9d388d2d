"""CMA (constant modulus algorithm) equalizers: the SISO form and the 2x2
butterfly (DP) forms.

Port of ``vae_equalizer_tpu/models/cma.py`` with any leading batch dims (the
runs axis). ``cma_siso`` is the single-polarization per-symbol form of the
AWGN experiment (func_CMA_MQAM_shaping.py:142-168): a Python loop over
symbols with update=True (the plain version of kernel I,
``ops/cma_siso_kernel.py``, one epoch), one product over every symbol window
with frozen taps. The DP forms come in three update granularities, as in the
reference (shared_funcs.py:341-488):

  * ``cma_dp`` — per-symbol LMS updates; the taps feed back into the next
    output, so this plain version is a Python loop over symbols (the
    reference for kernel C, ``ops/cma_kernel.py``);
  * ``cma_batch_dp`` — taps update every ``batch_len`` symbols;
  * ``cma_flex_dp`` — taps update every ``symb_step`` symbols from the
    increments of the last ``batch_len`` symbols.

The last two share the chunked engine ``_cma_chunked`` (the reference for
kernel D, ``ops/cma_frame_kernel.py``): between updates the taps are
constant, so a chunk is one windowed product and the loop runs over chunks.

Updates accumulate raw increments and multiply by the error at update time;
the input is divided by the mean power of the *padded* signal.

Reference index convention: outputs are stored at ``k = i//sps - mh``, which
is negative for the first ``offset = mh - mh//sps`` symbols, so the output
and error arrays are cyclically rolled by ``-offset`` relative to symbol
order (shared_funcs.py:355-357), and the ``k % B`` update condition of
CMAbatch/CMAflex fires ``offset`` symbols late. Both quirks are kept exactly
(the downstream sync search absorbs the roll).

DP shapes: rx (..., 2 pol, 2 I/Q, N) at ``sps`` samples per symbol; h
(..., 2 out-pol chi, 2 in-pol nu, 2 re/im, M). Returns (out (..., 2, 2,
N//sps), h, e (..., N//sps, 2)).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.reduce import run_mean

__all__ = ["dirac_taps_siso", "dirac_taps_dp", "cma_siso", "cma_dp", "cma_batch_dp", "cma_flex_dp"]


def dirac_taps_siso(m_est: int, device="cpu") -> torch.Tensor:
    """Dirac SISO complex taps (2 re/im, M): h[0, M//2] = 1 (the VAE-LE's
    initial channel estimate)."""
    h = torch.zeros((2, m_est), dtype=torch.float32, device=device)
    h[0, m_est // 2] = 1.0
    return h


def dirac_taps_dp(m_est: int, device="cpu") -> torch.Tensor:
    """Dirac 2x2 complex taps (2 out-pol, 2 in-pol, 2 re/im, M): h[p, p, 0, M//2] = 1."""
    h = torch.zeros((2, 2, 2, m_est), dtype=torch.float32, device=device)
    h[0, 0, 0, m_est // 2] = 1.0
    h[1, 1, 0, m_est // 2] = 1.0
    return h


def cma_siso(rx, R: float, h, lr, sps: int, update: bool = True):
    """Per-symbol CMA, single polarization.

    rx (..., 2 re/im, N) at ``sps`` samples per symbol (not normalized); h
    (..., 2 re/im, M). With y = rx zero-padded by M//2 on both sides, per
    symbol s the window w = y[..., s sps : s sps + M], o = w . h (complex),
    e = R - |o|^2 and, with ``update``, h += 2 lr e o conj(w), i.e.
    (o_re w_I + o_im w_Q, o_im w_I - o_re w_Q). Returns (out (..., 2,
    N//sps), h, e (..., N//sps)) in the reference's rolled storage order.
    """
    m = h.shape[-1]
    mh = m // 2
    y = F.pad(rx, (mh, mh))
    n_sym = rx.shape[-1] // sps
    offset = mh - mh // sps
    if not update:  # frozen taps: every symbol's output in one product
        w = y.unfold(-1, m, sps)[..., :n_sym, :]  # (..., 2, T, M)
        dot = lambda a, b: (a @ b[..., :, None])[..., 0]  # noqa: E731
        o_re = dot(w[..., 0, :, :], h[..., 0, :]) - dot(w[..., 1, :, :], h[..., 1, :])
        o_im = dot(w[..., 0, :, :], h[..., 1, :]) + dot(w[..., 1, :, :], h[..., 0, :])
        e = R - o_re * o_re - o_im * o_im
        out = torch.stack([o_re, o_im], dim=-2)
        return torch.roll(out, -offset, dims=-1), h, torch.roll(e, -offset, dims=-1)
    # the recurrence in complex arithmetic: o = w . h, h += 2 lr e o conj(w)
    wins = torch.complex(y[..., 0, :], y[..., 1, :]).unfold(-1, m, sps)  # (..., T, M)
    hc = torch.complex(h[..., 0, :], h[..., 1, :])
    outs, es = [], []
    for k in range(n_sym):
        w = wins[..., k, :]
        o = (w * hc).sum(-1)
        e = R - (o.real * o.real + o.imag * o.imag)
        hc = hc + ((2 * lr) * e * o)[..., None] * w.conj()
        outs.append(o)
        es.append(e)
    o = torch.stack(outs, dim=-1)  # (..., T)
    out = torch.stack([o.real, o.imag], dim=-2)
    h = torch.stack([hc.real, hc.imag], dim=-2)
    return torch.roll(out, -offset, dims=-1), h, torch.roll(torch.stack(es, dim=-1), -offset, dims=-1)


def _normalize_dp(rx: torch.Tensor, mh: int) -> torch.Tensor:
    """Zero-pad time by mh on both sides, divide by the padded mean power."""
    y = F.pad(rx, (mh, mh))
    power = run_mean(y[..., 0, :] ** 2 + y[..., 1, :] ** 2, (-2, -1))
    return y / power[..., None, None, None]


def _butterfly_out(w: torch.Tensor, h: torch.Tensor):
    """w (..., nu, c, M) windows; h (..., chi, nu, c, M), batch dims broadcast.

    Returns (o_re, o_im) (..., chi).
    """
    w = w.unsqueeze(-4)
    dot = lambda a, b: (a * b).sum(dim=(-2, -1))
    o_re = dot(w[..., 0, :], h[..., 0, :]) - dot(w[..., 1, :], h[..., 1, :])
    o_im = dot(w[..., 0, :], h[..., 1, :]) + dot(w[..., 1, :], h[..., 0, :])
    return o_re, o_im


def _increments(w: torch.Tensor, o_re: torch.Tensor, o_im: torch.Tensor) -> torch.Tensor:
    """CMA tap increments (unscaled by lr and e).

    w (..., nu, c, M); o_re/o_im (..., chi). Returns (..., chi, nu, c, M).
    """
    w0 = w[..., None, :, 0, :]  # (..., 1, nu, M)
    w1 = w[..., None, :, 1, :]
    ore = o_re[..., :, None, None]
    oim = o_im[..., :, None, None]
    inc_re = ore * w0 + oim * w1  # d/dh[..., 0, :]
    inc_im = oim * w0 - ore * w1  # d/dh[..., 1, :]
    return torch.stack([inc_re, inc_im], dim=-2)


def _window(y: torch.Tensor, k: int, m: int, sps: int) -> torch.Tensor:
    """The window of symbol k: (..., nu, c, M)."""
    return y[..., k * sps : k * sps + m]


def _all_windows(y: torch.Tensor, k0: int, count: int, m: int, sps: int) -> torch.Tensor:
    """Windows of symbols k0 .. k0+count-1: (..., T, nu, c, M), a strided view."""
    return y.unfold(-1, m, sps)[..., k0 : k0 + count, :].movedim(-2, -4)


def _roll_storage(out_re, out_im, e, offset: int):
    """Symbol-order (..., T, chi) streams -> the reference's rolled storage:
    (out (..., 2, 2, T), e (..., T, 2))."""
    out = torch.stack([out_re, out_im], dim=-1).movedim(-3, -1)  # (..., chi, comp, T)
    return torch.roll(out, -offset, dims=-1), torch.roll(e, -offset, dims=-2)


def cma_dp(rx, R: float, h, lr, sps: int, update: bool = True):
    """Per-symbol 2x2 butterfly CMA (the plain version of kernel C)."""
    m = h.shape[-1]
    mh = m // 2
    y = _normalize_dp(rx, mh)
    n_sym = rx.shape[-1] // sps
    outs_re, outs_im, es = [], [], []
    for k in range(n_sym):
        w = _window(y, k, m, sps)  # (..., nu, c, M)
        o_re, o_im = _butterfly_out(w, h)  # (..., chi)
        e = R - o_re * o_re - o_im * o_im
        if update:
            h = h + 2 * lr * e[..., None, None, None] * _increments(w, o_re, o_im)
        outs_re.append(o_re)
        outs_im.append(o_im)
        es.append(e)
    stack = lambda a: torch.stack(a, dim=-2)  # (..., T, chi)
    out, e = _roll_storage(stack(outs_re), stack(outs_im), stack(es), mh - mh // sps)
    return out, h, e


def chunk_schedule(n_sym: int, batch_len: int, symb_step: int, mh: int, sps: int):
    """Update points of the chunked engine, in symbol order.

    Updates fire at storage indices k that are multiples of S and >= B and
    use the increments of [k - B, k); the output at k is computed before the
    update (shared_funcs.py:398-433, 453-487). In symbol order that is
    j0 + c S with j0 = ceil(B / S) S + offset. Returns (j0, n_full, tail):
    n_full full S-chunks, then one last update and ``tail`` (1..S) outputs.
    """
    offset = mh - mh // sps
    j0 = -(-batch_len // symb_step) * symb_step + offset
    if n_sym <= j0:
        raise ValueError(f"frame too short for chunked CMA: N_sym={n_sym} <= j0={j0}")
    n_full = (n_sym - j0 - 1) // symb_step
    return j0, n_full, n_sym - j0 - n_full * symb_step


def _run_const(y, k0: int, count: int, h, R: float, m: int, sps: int):
    """(o_re, o_im, e (..., T, chi), windows (..., T, nu, c, M)) of the
    ``count`` symbols from k0 with constant taps h."""
    w = _all_windows(y, k0, count, m, sps)  # (..., T, nu, c, M)
    o_re, o_im = _butterfly_out(w, h.unsqueeze(-5))  # (..., T, chi)
    e = R - o_re**2 - o_im**2
    return o_re, o_im, e, w


def _chunk_update(h, ring_e, ring_w, ring_ore, ring_oim, lr):
    """h + 2 lr sum_t e_t inc_t over the ring of the last B symbols."""
    inc = _increments(ring_w, ring_ore, ring_oim)  # (..., B, chi, nu, c, M)
    return h + 2 * lr * torch.einsum("...tx,...txvck->...xvck", ring_e, inc)


def _cma_chunked(rx, R: float, h, lr, batch_len: int, symb_step: int, sps: int, update: bool):
    """Shared engine of CMAbatch (symb_step == batch_len) and CMAflex.

    The loop runs over the update points (``chunk_schedule``); the ring of
    the last B symbols is kept as their windows, outputs and errors, and
    the increments are formed at update time.
    """
    m = h.shape[-1]
    mh = m // 2
    n_sym = rx.shape[-1] // sps
    B, S = batch_len, symb_step
    offset = mh - mh // sps
    y = _normalize_dp(rx, mh)

    if not update:
        o_re, o_im, e, _ = _run_const(y, 0, n_sym, h, R, m, sps)
        out, e = _roll_storage(o_re, o_im, e, offset)
        return out, h, e

    j0, n_full, tail = chunk_schedule(n_sym, B, S, mh, sps)
    o_re, o_im, e, w = _run_const(y, 0, j0, h, R, m, sps)  # prefix: the initial taps
    ore_l, oim_l, e_l = [o_re], [o_im], [e]
    ring = [a[..., j0 - B :, :] for a in (e, w.flatten(-3), o_re, o_im)]
    for c in range(n_full + 1):
        k = j0 + c * S
        # the symbol at the update point sees the taps before the update
        o_re0, o_im0, e0, w0 = _run_const(y, k, 1, h, R, m, sps)
        ring_e, ring_w, ring_ore, ring_oim = ring
        h = _chunk_update(h, ring_e, ring_w.unflatten(-1, (2, 2, m)), ring_ore, ring_oim, lr)
        count = (S if c < n_full else tail) - 1
        o_re, o_im, e, w = _run_const(y, k + 1, count, h, R, m, sps)
        if c < n_full:  # no update follows the tail
            new = [torch.cat(p, dim=-2) for p in ((e0, e), (w0.flatten(-3), w.flatten(-3)),
                                                  (o_re0, o_re), (o_im0, o_im))]
            ring = [torch.cat([r[..., S:, :], n], dim=-2) for r, n in zip(ring, new)]
        ore_l += [o_re0, o_re]
        oim_l += [o_im0, o_im]
        e_l += [e0, e]
    out, e = _roll_storage(torch.cat(ore_l, dim=-2), torch.cat(oim_l, dim=-2),
                           torch.cat(e_l, dim=-2), offset)
    return out, h, e


def cma_batch_dp(rx, R: float, h, lr, batch_len: int, sps: int, update: bool = True):
    """Butterfly CMA with batched tap updates every ``batch_len`` symbols."""
    return _cma_chunked(rx, R, h, lr, batch_len, batch_len, sps, update)


def cma_flex_dp(rx, R: float, h, lr, batch_len: int, symb_step: int, sps: int,
                update: bool = True):
    """Butterfly CMA, sliding-window updates every ``symb_step`` symbols."""
    return _cma_chunked(rx, R, h, lr, batch_len, symb_step, sps, update)
