"""The dp x sp mesh of ``torch.distributed`` ranks and its collectives (the
mesh half of ``vae_equalizer_tpu/parallel/seqpar.py``).

A mesh is ``n_dp * n_sp`` ranks, rank ``dp * n_sp + sp`` (JAX's
``devices.reshape(n_dp, n_sp)``), each with its device. ``dp`` splits the
independent runs; ``sp`` splits the time axis of every minibatch, and the
ranks of one dp row form that row's sp group. Under ``nccl`` every rank
needs a card of its own; under ``gloo`` several ranks may share one card
(one H100 runs two ranks on ``cuda:0``), or run on the CPU.

The two differentiable collectives are JAX's under ``shard_map``:

* ``sp_sum``: all-reduce SUM over the sp group forward, identity backward
  (``psum``'s transpose is a pass-through per shard). The gradient psum
  after the backward then sums each shard's contributions once; the stock
  differentiable all-reduce sums in its backward too and would step with
  ``n_sp`` times the gradient.
* ``halo_exchange``: a block's last axis extended by its neighbours' edges,
  zero at the frame's edges (``ppermute``); its backward sends each halo's
  gradient back to its owner, which adds it into its edge columns (the
  reverse ``ppermute``). Both directions ride one ``all_gather`` of the
  edges over the sp group.

``run_ranks`` is the single controller: the caller's process is rank 0 and
spawns ranks 1.. (the ``spawn`` start method: CUDA cannot fork); a rank's
exception fails the caller (``ProcessRaisedException``), and the process
group's timeout fails a run whose peer died instead of hanging it.

Under ``gloo`` a card's tensors go through the host inside the backend:
each collective the runners use (``all_reduce``, ``all_gather``,
``scatter``, ``gather``) takes them as they are and returns them on the
card (``tools/first_check_seqpar.py`` probes each on the H100), so the math
stays on the card and nothing here stages.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import shutil
import tempfile
import time
from typing import Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["Call", "Comm", "Mesh", "halo_exchange", "make_mesh_2d", "run_ranks", "sp_sum"]

# seconds a collective may wait for a peer before the run fails
TIMEOUT_S = 120


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_dp`` x ``n_sp`` ranks; ``devices[rank]`` is the rank's device."""

    n_dp: int
    n_sp: int
    devices: tuple[str, ...]
    backend: str

    @property
    def size(self) -> int:
        return self.n_dp * self.n_sp

    def sp_ranks(self, rank: int) -> list[int]:
        """The ranks of ``rank``'s sp group (its dp row), in sp order."""
        d = rank // self.n_sp
        return [d * self.n_sp + s for s in range(self.n_sp)]

    def dp_ranks(self, rank: int) -> list[int]:
        """The ranks of ``rank``'s dp group (its sp column), in dp order."""
        s = rank % self.n_sp
        return [d * self.n_sp + s for d in range(self.n_dp)]


def make_mesh_2d(n_dp: int, n_sp: int, devices=None, backend: str | None = None) -> Mesh:
    """A ``("dp", "sp")`` mesh of ``n_dp * n_sp`` ranks.

    ``devices``: one device per rank (a sequence), or one device for all; by
    default ``cuda:0 .. cuda:W-1``, which raises when there are fewer cards
    than ranks. ``backend``: ``"nccl"`` (one distinct card per rank) or
    ``"gloo"`` (any devices, ranks may share a card); by default nccl where
    every rank has a card of its own, else gloo. A backend that cannot serve
    the devices raises; none is swapped for another.
    """
    if n_dp < 1 or n_sp < 1:
        raise ValueError(f"mesh dims must be >= 1, got dp={n_dp} sp={n_sp}")
    w = n_dp * n_sp
    if devices is None:
        n_cards = torch.cuda.device_count()
        if n_cards < w:
            raise RuntimeError(
                f"a {n_dp} x {n_sp} mesh needs {w} cards, {n_cards} present; pass devices= "
                f"(e.g. ['cuda:0'] * {w} with backend='gloo', or 'cpu')")
        devices = [f"cuda:{i}" for i in range(w)]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices] * w
    devs = [torch.device(d) for d in devices]
    if len(devs) != w:
        raise ValueError(f"a {n_dp} x {n_sp} mesh needs {w} devices, got {len(devs)}")
    devs = [torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d for d in devs]
    distinct_cards = all(d.type == "cuda" for d in devs) and len(set(devs)) == w
    if backend is None:
        backend = "nccl" if distinct_cards else "gloo"
    if backend == "nccl" and not distinct_cards:
        raise ValueError(f"nccl needs one distinct card per rank, got {[str(d) for d in devs]}: "
                         "ranks that share a card or run on the CPU need backend='gloo'")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    for d in devs:
        if d.type not in ("cuda", "cpu"):
            raise ValueError(f"device {d}: a rank runs on a card or the CPU")
        if d.type == "cuda" and d.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {d}: {torch.cuda.device_count()} cards present")
    return Mesh(n_dp, n_sp, tuple(str(d) for d in devs), backend)


class Comm:
    """One rank's view of the mesh inside its process group: its coordinates
    (``dp``, ``sp``), its device, its sp group, and the collectives the
    sharded runners use. ``collective_s`` sums the host seconds spent in
    them; with ``sync_timing`` each first waits for the device, so the sum
    holds only the collectives' own time."""

    def __init__(self, mesh: Mesh, rank: int):
        self.mesh, self.rank = mesh, rank
        self.dp, self.sp = divmod(rank, mesh.n_sp)
        self.n_sp = mesh.n_sp
        self.device = torch.device(mesh.devices[rank])
        # new_group is collective: every rank creates every row's group, in order
        groups = [dist.new_group(mesh.sp_ranks(d * mesh.n_sp)) for d in range(mesh.n_dp)]
        self.sp_group = groups[self.dp]
        self.collective_s = 0.0
        self.sync_timing = False

    def _start(self) -> float:
        if self.sync_timing and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _stop(self, t0: float) -> None:
        self.collective_s += time.perf_counter() - t0

    def all_reduce_sp(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the sp group, in place; returns ``t``."""
        t0 = self._start()
        dist.all_reduce(t, group=self.sp_group)
        self._stop(t0)
        return t

    def all_gather_sp(self, t: torch.Tensor) -> list[torch.Tensor]:
        """``t`` of every rank of the sp group, in sp order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.n_sp)]
        t0 = self._start()
        dist.all_gather(parts, t, group=self.sp_group)
        self._stop(t0)
        return parts

    def scatter(self, chunks: list | None, shape, dtype=torch.float32) -> torch.Tensor:
        """Rank 0's ``chunks[rank]`` (one per rank, each ``shape``) on every
        rank's device; ``chunks`` is None on the other ranks."""
        out = torch.empty(shape, dtype=dtype, device=self.device)
        src = [c.contiguous() for c in chunks] if self.rank == 0 else None
        t0 = self._start()
        dist.scatter(out, src, src=0)
        self._stop(t0)
        return out

    def gather(self, t: torch.Tensor) -> list[torch.Tensor] | None:
        """``t`` of every rank (equal shapes), on rank 0 in rank order; None
        on the other ranks."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.mesh.size)] if self.rank == 0 else None
        t0 = self._start()
        dist.gather(t, parts, dst=0)
        self._stop(t0)
        return parts


class _SpSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce_sp(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def sp_sum(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """``psum`` over the sp group: the sum forward, the identity backward."""
    return _SpSum.apply(x, comm)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, left, right, comm):
        n, j, ln = comm.n_sp, comm.sp, x.shape[-1]
        ctx.left, ctx.right, ctx.comm = left, right, comm
        parts = comm.all_gather_sp(torch.cat([x[..., ln - left:], x[..., :right]], dim=-1))
        zeros = lambda k: x.new_zeros(x.shape[:-1] + (k,))  # noqa: E731
        lh = parts[j - 1][..., :left] if j > 0 else zeros(left)
        rh = parts[j + 1][..., left:] if j < n - 1 else zeros(right)
        return torch.cat([lh, x, rh], dim=-1)

    @staticmethod
    def backward(ctx, g):
        left, right, comm = ctx.left, ctx.right, ctx.comm
        n, j = comm.n_sp, comm.sp
        ln = g.shape[-1] - left - right
        gx = g[..., left : left + ln].clone()
        # each halo's gradient goes back to the rank whose edge it copied
        parts = comm.all_gather_sp(torch.cat([g[..., :left], g[..., left + ln:]], dim=-1))
        if j < n - 1 and left:  # the right neighbour's left halo is my last `left` columns
            gx[..., ln - left:] += parts[j + 1][..., :left]
        if j > 0 and right:  # the left neighbour's right halo is my first `right` columns
            gx[..., :right] += parts[j - 1][..., left:]
        return gx, None, None, None


def halo_exchange(x: torch.Tensor, left: int, right: int, comm: Comm) -> torch.Tensor:
    """Pad the last axis of a sp-sharded block with neighbour data: returns
    (..., left + L + right), zero-filled at the frame's edges; differentiable
    (the halo's gradient reaches its owner's edge columns)."""
    if not (0 <= left <= x.shape[-1] and 0 <= right <= x.shape[-1]):
        raise ValueError(f"halo ({left}, {right}) exceeds the block length {x.shape[-1]}")
    if left == right == 0:
        return x
    return _Halo.apply(x, left, right, comm)


@dataclasses.dataclass
class Call:
    """``fn(comm, *args, **kwargs)`` on every rank, plus ``root`` keyword
    arguments on rank 0 only (closures such as ``draws`` and ``progress``,
    which never leave the caller's process). ``fn``, ``args`` and ``kwargs``
    are pickled to the spawned ranks: ``fn`` must be a module-level function
    they can import, of this package or of the script run as ``__main__``."""

    fn: Callable
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)
    root: dict = dataclasses.field(default_factory=dict)


def _run_rank(mesh: Mesh, rank: int, init: str, calls: list) -> list:
    dev = torch.device(mesh.devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(mesh.backend, init_method=init, rank=rank, world_size=mesh.size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        comm = Comm(mesh, rank)
        return [c.fn(comm, *c.args, **c.kwargs, **(c.root if rank == 0 else {})) for c in calls]
    finally:
        dist.destroy_process_group()


def _spawned(i: int, mesh: Mesh, init: str, calls: list) -> None:
    torch.set_num_threads(1)  # W ranks share the host's cores
    _run_rank(mesh, i + 1, init, calls)


def run_ranks(mesh: Mesh, calls: list[Call]) -> list:
    """Run ``calls`` in order on every rank of ``mesh``; returns rank 0's
    results. Rank 0 is this process (its device current while it runs);
    ranks 1.. are spawned processes, joined before this returns. A rank's
    exception is raised here: a spawned rank's as ``ProcessRaisedException``
    (chained to the collective error it caused on rank 0); rank 0's own
    stops the spawned ranks at once.
    Refuses a process that is already in a process group: there, call the
    per-rank functions on a ``Comm`` of that group."""
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError("run_ranks starts its own process group; inside an initialized one, "
                           "call the per-rank function with Comm(mesh, dist.get_rank())")
    tmp = tempfile.mkdtemp(prefix="vae_mesh_")
    init = "file://" + os.path.join(tmp, "store")
    ctx = None
    try:
        if mesh.size > 1:
            sent = [dataclasses.replace(c, root={}) for c in calls]  # root's stay here
            ctx = mp.start_processes(_spawned, args=(mesh, init, sent), nprocs=mesh.size - 1,
                                     join=False, start_method="spawn")
        dev = torch.device(mesh.devices[0])
        try:
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                out = _run_rank(mesh, 0, init, calls)
        except RuntimeError:
            if ctx is not None:  # a collective failed: a spawned rank's failure is the cause
                ctx.join(timeout=30)
            raise
        if ctx is not None:
            while not ctx.join():
                pass
        return out
    finally:
        if ctx is not None:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(10)
        shutil.rmtree(tmp, ignore_errors=True)

