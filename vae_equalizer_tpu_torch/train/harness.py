"""Frame and epoch loop harness (port of ``vae_equalizer_tpu/train/harness.py``).

A loop's step updates static buffers in place: the carry (parameters,
moments, taps, step counts), a frame counter on the device by which it
reads its per-frame inputs from device tables (theta, the CMA lr, the
injected draws), and a device history into whose row ``counter`` it writes
its packed metrics (``pack_metrics``). ``StepGraphs`` runs such steps in
three ways, on the same code path:

* the loop mode calls the step eagerly once per frame and copies that row
  to the host (one device-to-host copy per frame);
* ``compiled=True`` (JAX's one-program experiment) warms the step up,
  captures it once as a CUDA graph and replays it over every frame back to
  back, then copies the whole history once;
* ``chunk_frames=k`` replays it k frames per chunk and copies k rows per
  chunk (``progress`` per frame, k at a time; checkpoints at chunk ends).

The same kernels run in the same order on the same inputs in all three, and
the default draws' ``torch.Generator`` is registered with each graph, so
its offset advances per replay exactly as per eager call: the modes agree
bit for bit. On the CPU (the tests) the graph modes call the step eagerly
where the card would replay it. A capture that fails raises: nothing falls
back to the loop mode.

``Checkpoint`` is the loops' resume state (JAX ``_save_state`` /
``_load_state``): a killed experiment restarts at its last saved frame or
epoch instead of at 0, and runs on bit for bit as the uninterrupted run.
JAX derives every frame's key from the experiment key; the port's default
draws come from one sequential ``torch.Generator``, so the generator's state
travels with the carry.
"""

from __future__ import annotations

import os
import pathlib
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..ops import _build

__all__ = ["Checkpoint", "Progress", "StepGraphs", "pack_metrics", "unpack_metrics",
           "run_frame_loop", "table_rows"]

Fields = Sequence[tuple[str, int]]
Progress = Callable[[int, dict], None] | None


def pack_metrics(m: dict, fields: Fields, batch_ndim: int = 0) -> torch.Tensor:
    """Concatenate the named metrics into (*batch, n_total) float32."""
    parts = []
    for k, _ in fields:
        v = torch.as_tensor(m[k]).to(torch.float32)
        parts.append(v.reshape(v.shape[:batch_ndim] + (-1,)))
    return torch.cat(parts, dim=-1)


def unpack_metrics(v: np.ndarray, fields: Fields) -> dict:
    out, i = {}, 0
    for k, n in fields:
        out[k] = v[..., i] if n == 1 else v[..., i : i + n]
        i += n
    return out


def _leaves(tree) -> list:
    """The leaves of nested dicts (keys sorted), tuples and lists; None is empty."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [] if tree is None else [tree]


def _rebuild(tree, leaves):
    """``tree`` with its leaves taken in ``_leaves`` order from the iterator ``leaves``."""
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(t, leaves) for t in tree)
    return None if tree is None else next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.int64(leaf) if isinstance(leaf, int) else np.asarray(leaf)


def _like(arr: np.ndarray, leaf):
    """A saved leaf on the fresh leaf's device and in its dtype (Python ints stay ints)."""
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
    return type(leaf)(arr)


class Checkpoint:
    """A frame or epoch loop's state file: with ``path`` and ``every`` = K,
    the state after every K-th frame (epoch) short of the last is written to
    ``path``, and a loop that finds the file resumes from it.

    The file (``np.savez``, written to ``<name>.tmp`` and moved over the
    name with ``os.replace``, so a kill never leaves a partial file under the
    name) holds the carry's leaves by position (nested dicts, tuples and
    lists; tensors as arrays, Python ints such as Adam's step count as
    int64), the metric histories, the index of the next frame, ``ident``
    (the runner and its mode) and, where the runner draws from the
    generator ``rng``, its state. On resume each leaf goes to the fresh
    carry's device and dtype; a file whose identity, leaf count or shapes do
    not match the fresh carry, or whose generator state cannot be restored
    on ``rng``'s device, raises ``ValueError`` before anything is touched.
    Without ``path`` nothing is written or read.
    """

    def __init__(self, path=None, every: int = 0, rng: torch.Generator | None = None,
                 ident: str = ""):
        self.path = pathlib.Path(path) if path else None
        self.every, self.rng, self.ident = every, rng, ident

    def due(self, done: int, total: int, since: int | None = None) -> bool:
        """Whether the state after ``done`` of ``total`` frames is saved: every
        K-th frame, or with ``since`` (frames run since the last save, at a
        chunk's end) once ``since`` >= K (JAX's chunk-boundary rule)."""
        if not (self.path and self.every and done < total):
            return False
        return done % self.every == 0 if since is None else since >= self.every

    def save(self, done: int, carry, hist: dict) -> None:
        flat = {f"leaf_{i:04d}": _to_numpy(leaf) for i, leaf in enumerate(_leaves(carry))}
        flat.update({f"hist_{k}": v for k, v in hist.items()})
        flat["frame"] = np.int64(done)
        flat["ident"] = np.str_(self.ident)
        if self.rng is not None:
            flat["rng_state"] = self.rng.get_state().numpy()
            flat["rng_device"] = np.str_(self.rng.device.type)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_name(self.path.name + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, self.path)

    def resume(self, carry, hist: dict):
        """(next frame, carry): (0, ``carry``) without a file, else the
        saved state, with ``hist`` filled in place and the generator set."""
        if self.path is None or not self.path.exists():
            return 0, carry
        with np.load(self.path) as d:
            saved = {k: d[k] for k in d.files}
        leaves = _leaves(carry)
        n_saved = sum(k.startswith("leaf_") for k in saved)
        if (str(saved["ident"]) != self.ident or n_saved != len(leaves)
                or any(saved[f"leaf_{i:04d}"].shape != tuple(np.shape(leaf))
                       for i, leaf in enumerate(leaves))
                or any(saved.get(f"hist_{k}", np.empty(0)).shape != v.shape
                       for k, v in hist.items())):
            raise ValueError(
                f"checkpoint {self.path} ({saved['ident']}, {n_saved} training-state leaves) does "
                f"not match this runner's carry ({self.ident}, {len(leaves)} leaves) — it was "
                "written by a different runner mode (e.g. use_pallas toggled) or configuration; "
                "delete it or rerun with the original settings")
        if self.rng is not None:
            if "rng_state" not in saved or str(saved["rng_device"]) != self.rng.device.type:
                raise ValueError(
                    f"checkpoint {self.path} holds no draw-generator state for a "
                    f"{self.rng.device.type} generator — it was written with other draws or on "
                    "another device; delete it or rerun with the original settings")
            self.rng.set_state(torch.from_numpy(saved["rng_state"]))
        for k, v in hist.items():
            v[...] = saved[f"hist_{k}"]
        it = iter(_like(saved[f"leaf_{i:04d}"], leaf) for i, leaf in enumerate(leaves))
        return int(saved["frame"]), _rebuild(carry, it)


def table_rows(tables, index: torch.Tensor) -> list:
    """Row ``index`` (a one-element int64 tensor on the device) of each
    per-frame device table, without a host round trip: what a graph step
    reads by its counter."""
    return [t.index_select(0, index)[0] for t in tables]


def _counts() -> dict:
    return {c: c.launches for c in _build.COUNTED}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StepGraphs:
    """Steps of a loop over static buffers, replayed as CUDA graphs on the
    card or called eagerly.

    ``steps`` {name: fn()}: each step reads and updates in place the static
    tensors ``state`` (the carry and the counters) and may draw from ``rng``
    (the default draws' generator, or None). With ``graph`` each step is
    warmed up once (``warm_up``; on the card on a side stream, then the
    state, the generator and the launch counts are put back, so the kernels
    and cuFFT's plans are built without moving the experiment's draws),
    captured once (``capture``: ``torch.cuda.graph``, the generator
    registered with ``CUDAGraph.register_generator_state``) and replayed by
    ``run``. Off the card, and in the loop mode, ``run`` calls the step.

    Launch counts (``ops/_build.py: counted``): a capture adds nothing; each
    replay adds, per kernel wrapper, the launches that its capture recorded,
    so a wrapper's ``launches`` counts the kernel's executions on the path
    (captured launches x replays). The warm-up's launches are not counted.
    """

    def __init__(self, steps: dict, state: list, rng, device, graph: bool):
        self.steps, self.state, self.rng = steps, state, rng
        self.device = torch.device(device)
        self.graph = graph and self.device.type == "cuda"
        self.graphs: dict = {}

    def snapshot(self):
        """(copies of the state, the generator's state): what ``restore`` puts back."""
        return ([t.clone() for t in self.state],
                None if self.rng is None else self.rng.get_state())

    def restore(self, snap) -> None:
        saved, rng_state = snap
        for t, v in zip(self.state, saved):
            t.copy_(v)
        if rng_state is not None:
            self.rng.set_state(rng_state)

    def warm_up(self) -> None:
        """Run every step once and put back the state, the draws and the counts."""
        snap, counts = self.snapshot(), _counts()
        if self.device.type == "cuda":
            cur = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                for fn in self.steps.values():
                    fn()
            cur.wait_stream(side)
        else:
            for fn in self.steps.values():
                fn()
        self.restore(snap)
        for c, n in counts.items():
            c.launches = n

    def capture(self) -> None:
        """Capture every step as a CUDA graph (on the card; a no-op off it)."""
        if not self.graph:
            return
        for name, fn in self.steps.items():
            g = torch.cuda.CUDAGraph()
            if self.rng is not None:
                g.register_generator_state(self.rng)
            before = _counts()
            with torch.cuda.graph(g):
                fn()
            self.graphs[name] = (g, {c: c.launches - n for c, n in before.items() if c.launches != n})
            for c, n in before.items():
                c.launches = n

    def build(self, timings: dict | None = None) -> None:
        """Warm up and capture; ``timings["compile_s"]``: the seconds both took."""
        t0 = time.perf_counter()
        self.warm_up()
        self.capture()
        _sync(self.device)
        if timings is not None:
            timings["compile_s"] = time.perf_counter() - t0

    def run(self, name: str) -> None:
        if not self.graph:
            self.steps[name]()
            return
        g, counts = self.graphs[name]
        g.replay()
        for c, n in counts.items():
            c.launches += n

    def timed(self, run_all: Callable, timings: dict | None):
        """``run_all()`` once, or with ``timings`` three times, each from the
        state and draws the first started from; ``timings["run_s"]``: the
        best of the three walls. Returns the last run's result."""
        if timings is None:
            return run_all()
        snap, best, out = self.snapshot(), None, None
        for i in range(3):
            if i:
                self.restore(snap)
            _sync(self.device)
            t0 = time.perf_counter()
            out = run_all()
            _sync(self.device)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        timings["run_s"] = best
        return out


def run_frame_loop(frame_step: Callable, carry, tables: tuple, fields: Fields, *,
                   num_frames: int, runs: int | None = None, progress: Progress = None,
                   ckpt: Checkpoint | None = None, host_rows: Callable | None = None,
                   compiled: bool = False, chunk_frames: int = 1, timings: dict | None = None):
    """Drive ``frame_step(carry, *rows) -> (carry, packed)`` over the frames.

    ``carry`` a nested tuple / dict of tensors on the device; ``rows`` the
    frame's rows of the device ``tables`` (leading dim ``num_frames``), then
    the tensors of ``host_rows(frame)`` where given (the caller's host-side
    inputs, e.g. injected draws: the loop mode calls it per frame, the graph
    modes call it for every frame up front and read the stacked tables by
    the counter). Modes (module docstring): the loop mode; ``compiled``
    (``progress`` unavailable, ``ckpt`` ignored, as in JAX); ``chunk_frames``
    = k > 1. ``timings`` (compiled mode): "compile_s", the warm-up and
    capture, and "run_s", the best of 3 replays of every frame, each from
    the initial carry and draws.

    With ``ckpt`` the loop resumes from its file and saves after every K-th
    frame before ``progress`` (JAX's order); chunked, at the end of a chunk
    once K frames have run since the last save, after ``progress``. Returns
    (carry, hist) with hist[name] a float32 array of shape ``(*runs_prefix,
    [n,] num_frames)``.
    """
    if chunk_frames < 1:
        raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
    prefix = () if runs is None else (runs,)
    hist = {
        k: np.zeros(prefix + ((n,) if n > 1 else ()) + (num_frames,), np.float32)
        for k, n in fields
    }
    ckpt = ckpt or Checkpoint()
    start, carry = (0, carry) if compiled else ckpt.resume(carry, hist)
    leaves = [leaf.clone() for leaf in _leaves(carry)]
    static = _rebuild(carry, iter(leaves))
    dev = leaves[0].device
    graphed = compiled or chunk_frames > 1
    tables = tuple(tables)
    if graphed and host_rows is not None:
        cols = zip(*(host_rows(f) for f in range(num_frames)))
        tables += tuple(torch.stack(c) for c in cols)
        host_rows = None
    t = torch.full((1,), start, dtype=torch.int64, device=dev)
    buf: dict = {}  # the device history (num_frames, *packed), made by the first step

    def step(frame=None):
        rows = table_rows(tables, t) + (list(host_rows(frame)) if host_rows else [])
        new, packed = frame_step(static, *rows)
        for s, v in zip(leaves, _leaves(new)):
            s.copy_(v)
        if "hist" not in buf:
            buf["hist"] = torch.zeros((num_frames,) + tuple(packed.shape), dtype=torch.float32,
                                      device=dev)
        buf["hist"].index_copy_(0, t, packed[None])
        t.add_(1)

    def record(frame: int, rows: np.ndarray) -> list:
        """Host rows (c, *packed) of frames frame.. into hist; their metrics."""
        ms = [unpack_metrics(r, fields) for r in rows]
        for i, m in enumerate(ms):
            for k, _ in fields:
                hist[k][..., frame + i] = m[k]
        return ms

    if not graphed:
        for frame in range(start, num_frames):
            step(frame)
            (m,) = record(frame, buf["hist"][frame : frame + 1].cpu().numpy())
            if ckpt.due(frame + 1, num_frames):
                ckpt.save(frame + 1, static, hist)
            if progress:
                progress(frame, m)
        return static, hist

    rng = ckpt.rng
    graphs = StepGraphs({"frame": step}, leaves + [t], rng, dev, graph=True)
    graphs.build(timings if compiled else None)
    if compiled:
        def run_all():
            for _ in range(num_frames):
                graphs.run("frame")

        graphs.timed(run_all, timings)
        record(0, buf["hist"].cpu().numpy())  # one device-to-host copy
        return static, hist

    frame, since = start, 0
    while frame < num_frames:
        c = min(chunk_frames, num_frames - frame)
        for _ in range(c):
            graphs.run("frame")
        ms = record(frame, buf["hist"][frame : frame + c].cpu().numpy())  # one copy per chunk
        if progress:
            for i, m in enumerate(ms):
                progress(frame + i, m)
        frame += c
        since += c
        if ckpt.due(frame, num_frames, since):
            ckpt.save(frame, static, hist)
            since = 0
    return static, hist
