"""Run sharding: an experiment's independent runs split over ``torch.distributed``
ranks (port of ``vae_equalizer_tpu/train/batching.py``: ``shard_runs`` of the
runs axis over ``run_mesh``).

No value crosses runs: each draws its own channel, trains its own parameters
and is evaluated alone. A mesh of ``n_dp`` ranks (``parallel/mesh.py``,
``n_sp`` = 1) splits them as JAX places its runs axis (``split_runs``): the
runs form units, and ``n = gcd(units, n_dp)`` ranks take equal contiguous
shares of them while the other ranks idle. With an explicit ``runs_batch`` a
unit is a group of ``runs_batch`` runs, as JAX shards its ``(groups,
runs_batch)`` carry; without one, a unit is one run. (JAX's default
``runs_batch`` is min(8, ...), so its flagship at R = 8 is one group that no
mesh splits; the port's runs are one launch's tensor axis, so a run is its
natural unit. The results do not depend on the split.)

A runner decorated with ``run_sharding`` takes ``mesh=``: every used rank
calls the runner on its share (``RunShard``) and rank 0, the caller's
process, gathers the result (``parallel/mesh.py: run_ranks``). On a rank:

* the default draws come from the same seeded generator on every rank,
  drawn for all R runs exactly as the call without a mesh draws them, and
  the rank keeps its rows; the caller's ``draws(..., R)`` run on rank 0,
  which sends each rank its rows;
* physics, the kernel launches and the evaluation run on the rank's runs
  alone. The step posts no collective, so ``compiled`` and ``chunk_frames``
  capture and replay it as a CUDA graph as the call without a mesh does;
* rank 0 gathers every run's result at the end, every run's metrics at each
  ``progress`` call (JAX's ``progress`` sees every run), and every run's
  carry and histories at a checkpoint save (``RankCheckpoint``: the file of
  the call without a mesh, so either resumes the other's).

So a call under a mesh equals the call with ``mesh=None`` wherever each
run's arithmetic does not depend on how many runs a tensor holds: bit for
bit on the CPU. A mesh whose split uses one rank (``run_mesh(device="cpu")``,
one card, or a run count that the rule does not split) runs in the caller's
process with no process group, on the ``mesh=None`` path on that rank's
device: the same computation, not a fallback. With ``runs=None`` the mesh
is ignored, as in JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import math
import time

import numpy as np
import torch

from ..ops import _build
from .harness import Checkpoint, _leaves, _rebuild, _sync

__all__ = ["RankCheckpoint", "RunShard", "run_sharding", "runs_call", "split_runs"]


def split_runs(runs: int, n_ranks: int, runs_batch: int | None = None) -> list[range]:
    """The runs of each rank that takes a share: JAX's ``shard_runs``
    placement of ``runs // runs_batch`` units (one run each without
    ``runs_batch``) over ``gcd(units, n_ranks)`` ranks, equal and contiguous."""
    rb = runs_batch or 1
    if runs < 1 or runs % rb != 0:
        raise ValueError(f"runs_batch={rb} must divide runs={runs}")
    n = math.gcd(runs // rb, n_ranks)
    k = runs // n
    return [range(i * k, (i + 1) * k) for i in range(n)]


def _check_mesh(mesh) -> None:
    from ..parallel.mesh import Mesh  # the parallel package imports train: here, at call time

    if not isinstance(mesh, Mesh):
        raise ValueError(f"mesh must be a parallel.Mesh (run_mesh / make_mesh_2d), got "
                         f"{type(mesh).__name__}")
    if mesh.n_sp != 1:
        raise ValueError(f"the runners shard runs only: a {mesh.n_dp} x {mesh.n_sp} mesh has an sp "
                         "axis (sequence parallelism is parallel/seqpar.py's)")


@dataclasses.dataclass(frozen=True)
class RunShard:
    """One process's share of a call's runs: ``runs`` (R, every run of the
    call), the ``rows`` it holds, and its rank's ``comm``
    (``parallel/mesh.py: Comm``), or None where this process holds every
    run. The runners take it as ``mesh`` on a rank."""

    runs: int
    rows: range
    comm: object = None

    @classmethod
    def of(cls, mesh, runs: int | None) -> "RunShard":
        """``mesh`` itself inside a rank, else every run of the call."""
        if isinstance(mesh, RunShard):
            return mesh
        R = 1 if runs is None else runs
        return cls(R, range(R))

    @property
    def count(self) -> int:
        return len(self.rows)

    def take(self, x):
        """This process's rows of ``x`` (a tensor or array with every run on
        axis 0): ``x`` itself where it holds every run."""
        return x if self.comm is None else x[self.rows.start : self.rows.stop]

    def gather(self, x):
        """Every rank's ``x`` (this rank's runs on axis 0) joined in rank order
        on rank 0, as ``x``'s type and device; None on the other ranks."""
        dev = self.comm.device
        t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        parts = self.comm.gather(t.to(dev))
        if parts is None:
            return None
        full = torch.cat(parts)
        return full.cpu().numpy() if isinstance(x, np.ndarray) else full.to(x.device)

    def gather_result(self, res: dict) -> dict | None:
        """A runner's result for this rank's runs -> every run's on rank 0
        (None elsewhere): each array leaf has the runs on axis 0, except the
        top-level "var" (the configured demapper variance), which is the same
        on every rank, as are Python numbers (Net_BN's momentum)."""
        def join(v, shared: bool):
            if isinstance(v, dict):
                return {k: join(x, False) for k, x in v.items()}
            if shared or not isinstance(v, (np.ndarray, torch.Tensor)):
                return v
            return self.gather(v)

        out = {k: join(v, k == "var") for k, v in res.items()}
        return out if self.comm.rank == 0 else None

    def progress(self, progress):
        """``progress(step, metrics)`` called on rank 0 with every run's
        metrics: each call gathers them (every rank calls it; ``progress`` is
        None on the other ranks)."""
        def gathered(step, m):
            full = {k: self.gather(np.asarray(v)) for k, v in m.items()}
            if progress is not None:
                progress(step, full)
        return gathered

    def caller_draws(self, draws):
        """The caller's ``draws(..., R)`` for every run, called on rank 0 (the
        closure never leaves the caller's process), each rank given its rows
        of every tensor it returns; ``draws`` is None on the other ranks."""
        comm = self.comm

        def local(*args):
            chunks = meta = None
            if comm.rank == 0:
                full = [torch.as_tensor(t).to(comm.device) for t in draws(*args[:-1], self.runs)]
                k = self.count
                chunks = [[t[r * k : (r + 1) * k] for r in range(comm.mesh.size)] for t in full]
                meta = [(tuple(c[0].shape), c[0].dtype) for c in chunks]
            meta = comm.broadcast_object(meta)
            return tuple(comm.scatter(None if chunks is None else chunks[i], shape, dtype)
                         for i, (shape, dtype) in enumerate(meta))
        return local

    def checkpoint(self, path=None, every: int = 0, rng=None, ident: str = "",
                   hist_axes: dict | None = None) -> Checkpoint:
        """The runner's ``Checkpoint``; on a rank a ``RankCheckpoint`` with the
        file of the call without a mesh. ``hist_axes`` {name: runs axis} of the
        histories whose runs are not on axis 0."""
        if self.comm is None:
            return Checkpoint(path, every, rng, ident)
        return RankCheckpoint(self.comm, path, every, rng, ident, hist_axes=hist_axes or {},
                              rng_shared=rng is not None)


def _per_run(leaf) -> bool:
    """Whether a carry leaf holds runs on axis 0: floating tensors (parameters,
    moments, taps) do; integer tensors (step and frame counts) and Python ints
    are the same on every rank."""
    return isinstance(leaf, torch.Tensor) and leaf.is_floating_point()


class RankCheckpoint(Checkpoint):
    """A ``Checkpoint`` on one rank of a mesh whose dp axis splits the runs
    (run sharding, and ``parallel/seqpar.py``'s dp x sp runners).

    The file is ``Checkpoint``'s, written and read by rank 0 alone: every
    run's carry (each per-run leaf with its whole runs axis; ``_per_run``),
    the histories, the next frame, the identity and rank 0's draw-generator
    state, so it does not depend on the split, and a run sharded one way
    resumes sharded another way or with no mesh. Every rank finds the due
    frames by the same rule (``due``), so the other frames post no
    collective. At a save each per-run leaf is gathered to rank 0 and joined
    in dp order (sp rank 0 of each dp row; the sp ranks of a row hold the
    same runs). ``hist_axes``: {name: runs axis} where each rank records its
    own runs' histories (run sharding; axis 0 where a name is absent),
    gathered likewise; None where rank 0 records every run's (sp sharding).
    On resume rank 0 reads the file (``ValueError`` where it does not
    match), and every rank is sent the next frame, its runs of each per-run
    leaf and history, the shared leaves and, with ``rng_shared`` (each rank
    draws from its own copy of the generator), the generator's state.
    ``saves`` (rank 0): (frame, gather seconds, write seconds) of every save.
    """

    def __init__(self, comm, path=None, every: int = 0, rng: torch.Generator | None = None,
                 ident: str = "", hist_axes: dict | None = None, rng_shared: bool = False):
        super().__init__(path, every, rng, ident)
        self.comm, self.hist_axes, self.rng_shared, self.saves = comm, hist_axes, rng_shared, []

    def _hist(self, hist: dict) -> list:
        """(name, runs axis) of the histories each rank holds its share of."""
        if self.hist_axes is None:
            return []
        return [(k, self.hist_axes.get(k, 0)) for k in sorted(hist)]

    def _join(self, t: torch.Tensor, axis: int):
        parts = self.comm.gather(t.to(self.comm.device))
        if parts is None:
            return None
        return torch.cat([parts[r] for r in self.comm.mesh.dp_ranks(0)], dim=axis)

    def _split(self, t: torch.Tensor, axis: int) -> list:
        mesh = self.comm.mesh
        parts = t.chunk(mesh.n_dp, dim=axis)
        return [parts[r // mesh.n_sp] for r in range(mesh.size)]

    def _whole(self, shape, axis: int) -> tuple:
        return tuple(s * self.comm.mesh.n_dp if i == axis else s for i, s in enumerate(shape))

    def save(self, done: int, carry, hist: dict) -> None:
        t0 = time.perf_counter()
        leaves = [self._join(leaf, 0) if _per_run(leaf) else leaf for leaf in _leaves(carry)]
        whole = dict(hist)
        for k, ax in self._hist(hist):
            whole[k] = self._join(torch.from_numpy(hist[k]), ax)
        if self.comm.rank != 0:
            return
        for k, ax in self._hist(hist):
            whole[k] = whole[k].cpu().numpy()
        t1 = time.perf_counter()
        super().save(done, _rebuild(carry, iter(leaves)), whole)
        self.saves.append((done, t1 - t0, time.perf_counter() - t1))

    def resume(self, carry, hist: dict):
        if self.path is None:
            return 0, carry
        comm, dev = self.comm, self.comm.device
        leaves, rows = _leaves(carry), self._hist(hist)
        everyone = lambda t: [t] * comm.mesh.size  # noqa: E731
        start, full, whole = 0, None, None
        if comm.rank == 0:
            template = [torch.zeros(self._whole(leaf.shape, 0), dtype=leaf.dtype, device=dev)
                        if _per_run(leaf) else leaf for leaf in leaves]
            whole = dict(hist)
            for k, ax in rows:
                whole[k] = np.zeros(self._whole(hist[k].shape, ax), hist[k].dtype)
            start, full = super().resume(_rebuild(carry, iter(template)), whole)
            full = _leaves(full)
        head = comm.scatter(everyone(torch.tensor([start], device=dev)) if comm.rank == 0 else None,
                            (1,), torch.int64)
        start = int(head)
        if start == 0:
            return 0, carry
        new = []
        for i, leaf in enumerate(leaves):
            if _per_run(leaf):
                src = None if full is None else self._split(full[i], 0)
                new.append(comm.scatter(src, leaf.shape, leaf.dtype))
            else:
                t = torch.as_tensor(leaf)
                src = None if full is None else everyone(torch.as_tensor(full[i], device=dev))
                got = comm.scatter(src, t.shape, t.dtype)
                new.append(got.to(leaf.device) if isinstance(leaf, torch.Tensor)
                           else type(leaf)(got))
        for k, ax in rows:
            src = None if whole is None else self._split(torch.from_numpy(whole[k]).to(dev), ax)
            hist[k][...] = comm.scatter(src, hist[k].shape, torch.float32).cpu().numpy()
        if self.rng_shared:
            state = self.rng.get_state()
            src = None if full is None else everyone(state.to(dev))
            self.rng.set_state(comm.scatter(src, state.shape, state.dtype).cpu())
        return start, _rebuild(carry, iter(new))


_ROOT = ("progress", "draws", "timings")  # closures and dicts that stay in the caller's process


def _host(x):
    """Tensors (in nested dicts) to the host: the spawned ranks unpickle them."""
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


def _rank_main(comm, fn, kwargs: dict, root_set: tuple, progress=None, draws=None, timings=None,
               stats: dict | None = None):
    """``fn(**kwargs)`` on this rank's share of the runs; rank 0 returns every
    run's result (None elsewhere). ``root_set``: which of ``_ROOT`` and
    "stats" the caller gave (rank 0 holds them; the other ranks join their
    gathers). ``stats`` (rank 0): "ranks", per rank {"start" (epoch seconds
    at which the rank began), "wall_s" (its runner, to the device's
    finish), "launches" {kernel wrapper: launches}}."""
    start = time.time()
    k = kwargs["runs"] // comm.mesh.size
    shard = RunShard(kwargs["runs"], range(comm.rank * k, (comm.rank + 1) * k), comm)
    kw = dict(kwargs, mesh=shard, device=comm.device)
    if "progress" in root_set:
        kw["progress"] = shard.progress(progress)
    if "draws" in root_set:
        kw["draws"] = shard.caller_draws(draws)
    if "timings" in root_set:
        kw["timings"] = timings if comm.rank == 0 else {}
    before = {c: c.launches for c in _build.COUNTED}
    t0 = time.perf_counter()
    res = fn(**kw)
    _sync(comm.device)
    wall = time.perf_counter() - t0
    out = shard.gather_result(res)
    if "stats" in root_set:
        ranks = comm.gather_object({
            "start": start, "wall_s": wall,
            "launches": {c.__name__: c.launches - n for c, n in before.items() if c.launches != n}})
        if stats is not None:
            stats["ranks"] = ranks
    return out


def _resolve(fn, args: tuple, kwargs: dict):
    """(the call's arguments by name, the ranks to spawn or None). With no
    ranks the arguments run here: ``mesh`` None (or a rank's ``RunShard``),
    and ``device`` the rank's where a mesh's split uses one rank."""
    bound = inspect.signature(fn).bind(*args, **kwargs)
    bound.apply_defaults()
    kw = dict(bound.arguments)
    mesh, runs = kw["mesh"], kw["runs"]
    if mesh is None or isinstance(mesh, RunShard):
        return kw, None
    _check_mesh(mesh)
    shares = [] if runs is None else split_runs(runs, mesh.n_dp, kw.get("runs_batch"))
    if len(shares) < 2:
        if shares:
            kw["device"] = mesh.devices[0]
        return dict(kw, mesh=None), None
    return kw, dataclasses.replace(mesh, n_dp=len(shares), devices=mesh.devices[: len(shares)])


def runs_call(fn, *args, stats: dict | None = None, **kwargs):
    """(the ranks, the ``Call`` of every rank) of the runner call ``fn(*args,
    **kwargs)`` with its ``mesh=`` (``parallel/mesh.py: run_ranks(ranks,
    [call, ...])`` runs it, with other calls on the same ranks); (None, None)
    where the call runs in this process (no mesh, ``runs=None``, or a split
    that uses one rank). Raises ``ValueError`` for a mesh that is not a
    ``Mesh`` or has an sp axis. ``stats``: ``_rank_main``'s. The kernels are
    built here first where a rank runs on a card, so the ranks load that build."""
    from ..parallel.mesh import Call

    kw, ranks = _resolve(fn, args, kwargs)
    if ranks is None:
        return None, None
    if any(d.startswith("cuda") for d in ranks.devices):
        _build.build()
    root = {k: kw.pop(k) for k in _ROOT if kw.get(k) is not None}
    if stats is not None:
        root["stats"] = stats
    kw = {k: _host(v) for k, v in kw.items()}
    return ranks, Call(_rank_main, (fn, kw, tuple(root)), root=root)


def run_sharding(fn):
    """Give the runner ``fn`` (with ``runs=``, ``mesh=`` and ``device=``
    parameters) its ``mesh``: None; a ``Mesh`` of dp ranks (``n_sp`` = 1),
    over whose used ranks the call runs (``runs_call``), or on whose first
    rank's device it runs here where the split uses one; or, on a rank, its
    ``RunShard``, which ``fn`` reads with ``RunShard.of``."""
    @functools.wraps(fn)
    def runner(*args, **kwargs):
        kw, ranks = _resolve(fn, args, kwargs)
        if ranks is None:
            return fn(**kw)
        from ..parallel.mesh import run_ranks

        ranks, call = runs_call(runner, **kw)
        return run_ranks(ranks, [call])[0]
    return runner
