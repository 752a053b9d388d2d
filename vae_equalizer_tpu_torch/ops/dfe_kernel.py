"""Kernel J: the DFE's decision-feedback loop, B independent chains in one launch.

No TPU kernel to replace: the JAX package runs this loop as a ``lax.scan``
(``vae_equalizer_tpu/models/lmmse_dfe.py: dfe_equalize``). Per chain, from
symbol K2 on, every symbol's feedforward output plus the feedback correction
from the last K2 hard decisions, c = sum_j fb[j] s[K2 - 1 - j] (complex),
is decided to the nearest constellation point (first index on ties, as
``jnp.argmin``), and the decided point enters the state; the first K2
decisions are the initial ones (the LMMSE's).

On the card (``csrc/dfe_kernel.cu`` + ``dfe_step.cuh``), two routes, picked
by ``dfe_route`` from the points table. The grid route, for a table that is
the Cartesian product of one level set per axis, real-major (an L x L grid,
L = 2, 4, 8, 16: every QAM of ``core/constellation.py``): one thread per
chain, a slicer (each axis's L squared distances, the first argmin of
dx + min dy over the rows, then of dx* + dy over the columns: the first
index of the smallest distance exactly, ties included), the older feedback
products summed off the chain. Any other table takes the general route: one
warp per chain, each lane holding its share of the points, the argmin a
5-level butterfly of (distance, index) pairs keeping the first index. Both
are bound by the latency of the dependent per-symbol chain; up to 132 chains
take an SM each. A rounding that flips one decision propagates through the
state, so both routes round every product and sum as the plain version does
(--fmad=false) and their decisions equal the plain version's bit for bit.

Dispatch: CPU tensors take ``dfe_decide_plain``; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["J_CLOCK_PHASES", "dfe_clocks", "dfe_decide", "dfe_decide_plain", "dfe_route"]

MAX_K2 = 4  # csrc/dfe_step.cuh: dfe::MAX_K2
MAX_POINTS = 256  # dfe::MAX_POINTS
GRID_LEVELS = (2, 4, 8, 16)  # L of the grid route's instantiations (csrc/dfe_kernel.cu)
# kernel J's per-symbol phases, in the order of csrc/dfe_step.cuh: enum JPhase
J_CLOCK_PHASES = ("correction", "distances", "argmin", "state update", "next ff")


def dfe_decide_plain(ff_out, fb, points, init_idx):
    """Plain version of kernel J (same arguments and return as ``dfe_decide``).

    The correction sums the flipped taps j = 0, 1, ... in order: a0..a3 =
    sum of f_re s_re, f_im s_im, f_re s_im, f_im s_re, c = (a0 - a1, a2 + a3)
    (a1 formed as the sum of -f_im s_im, which is -a1 exactly).
    """
    B, _, n = ff_out.shape
    k2 = fb.shape[-1]
    fbf = fb.flip(-1)
    f4 = torch.stack([fbf[:, 0], -fbf[:, 1], fbf[:, 0], fbf[:, 1]], dim=1)  # (B, 4, K2)
    p4 = points[[0, 1, 1, 0]]  # a point as the state's rows: re, im, im, re
    init = init_idx[:, :k2].long()
    state = p4[:, init].movedim(0, 1)  # (B, 4, K2), oldest first
    dec = []
    for t in range(k2, n):
        ik = ff_out[:, :, t]
        if k2:
            prod = f4 * state
            acc = prod[..., 0]
            for j in range(1, k2):
                acc = acc + prod[..., j]
            ik = ik + (acc[:, 0::2] + acc[:, 1::2])
        d = ik[:, :, None] - points
        k = torch.argmin((d * d).sum(1), dim=-1)  # first index on ties
        dec.append(k)
        if k2:
            state = torch.cat([state[..., 1:], p4[:, k].T[..., None]], dim=-1)
    rest = torch.stack(dec, dim=-1) if dec else init[:, :0]
    return torch.cat([init, rest], dim=-1).to(torch.int32)


def dfe_decide(ff_out, fb, points, init_idx):
    """The decision-feedback loop of B chains. Kernel J on a CUDA ``ff_out``,
    plain on the CPU.

    ff_out (B, 2, N) the feedforward output (re / im planes); fb (B, 2, K2)
    each chain's feedback taps; points (2, n_points) the constellation;
    init_idx (B, N) initial decisions, of which the first K2 seed the state.
    Returns the decisions (B, N) int32.
    """
    if not ff_out.is_cuda:
        return dfe_decide_plain(ff_out, fb, points, init_idx)
    return _launch(ff_out, fb, points, init_idx)


def dfe_route(points) -> tuple:
    """Kernel J's route for a (2, n_points) points table: ("grid", L) where
    the table is an L x L grid of finite levels, real-major (points[0][ix L +
    iy] = lx[ix] and points[1][ix L + iy] = ly[iy], bit for bit), with L in
    ``GRID_LEVELS``; else ("general", 0)."""
    pts = points.detach().cpu()
    L = round(pts.shape[-1] ** 0.5)
    if L not in GRID_LEVELS or L * L != pts.shape[-1] or not bool(torch.isfinite(pts).all()):
        return ("general", 0)
    bits = pts.contiguous().view(torch.int32).reshape(2, L, L)
    grid = torch.equal(bits[0], bits[0][:, :1].expand(L, L)) and \
        torch.equal(bits[1], bits[1][:1, :].expand(L, L))
    return ("grid", L) if grid else ("general", 0)


def dfe_clocks(ff_out, fb, points, init_idx) -> dict:
    """Kernel J once on CUDA tensors (the arguments of ``dfe_decide``) with its
    phase clocks: {phase: clock64() cycles per symbol} of chain 0's first
    lane, on the route ``dfe_route`` picks. For measurement only
    (chip_smoke.py); the runners never ask for it."""
    clocks = torch.zeros(len(J_CLOCK_PHASES), dtype=torch.int64, device=ff_out.device)
    _launch(ff_out, fb, points, init_idx, clocks)
    n_steps = max(ff_out.shape[-1] - fb.shape[-1], 1)
    return {k: c / n_steps for k, c in zip(J_CLOCK_PHASES, clocks.tolist())}


def _launch(ff_out, fb, points, init_idx, clocks=None):
    """Check the arguments, allocate the output and launch kernel J."""
    dev = ff_out.device
    B, _, n = ff_out.shape
    k2, n_points = fb.shape[-1], points.shape[-1]
    if k2 > MAX_K2 or n_points > MAX_POINTS or k2 > n:
        raise ValueError(f"kernel J takes at most {MAX_K2} feedback taps (<= N) and "
                         f"{MAX_POINTS} points, got {k2} and {n_points}")
    for name, t, shape in (("ff_out", ff_out, (B, 2, n)), ("fb", fb, (B, 2, k2)),
                           ("points", points, (2, n_points))):
        _build.check_tensor(name, t, shape, dev)
    if (init_idx.device != dev or init_idx.dtype != torch.int32 or not init_idx.is_contiguous()
            or tuple(init_idx.shape) != (B, n)):
        raise ValueError(f"init_idx: needs a contiguous int32 tensor of shape {(B, n)} on {dev}")
    grid_l = dfe_route(points)[1]
    lib = _build.load()
    idx = torch.empty((B, n), dtype=torch.int32, device=dev)
    rc = lib.dfe_decide_launch(B, n, k2, n_points, grid_l, ff_out.data_ptr(), fb.data_ptr(),
                               points.data_ptr(), init_idx.data_ptr(), idx.data_ptr(),
                               None if clocks is None else clocks.data_ptr(), _build.stream(dev))
    _build.check(rc, "dfe_decide_launch")
    dfe_decide.launches += 1
    return idx


_build.counted(dfe_decide)
