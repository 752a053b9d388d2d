"""Frame-loop harness (port of ``vae_equalizer_tpu/train/harness.py``, loop mode).

``frame_step(carry, *inputs) -> (carry, packed)`` is driven over the
experiment's frames from a Python loop. Each frame's metrics are packed on
the device into one float32 tensor (``pack_metrics``) and copied to the host
once, so the host waits on the device once per frame.

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
from typing import Callable, Sequence

import numpy as np
import torch

__all__ = ["Checkpoint", "Progress", "pack_metrics", "unpack_metrics", "run_frame_loop"]

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

    def due(self, done: int, total: int) -> bool:
        """Whether the state after ``done`` of ``total`` frames is saved."""
        return bool(self.path and self.every and done % self.every == 0 and done < total)

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


def run_frame_loop(frame_step: Callable, carry, per_frame: tuple, fields: Fields, *,
                   runs: int | None = None, progress: Progress = None,
                   ckpt: Checkpoint | None = None):
    """Drive ``frame_step`` over frames; per_frame = sequences indexed by frame.

    With ``ckpt`` the loop resumes from its file and saves after every K-th
    frame, before ``progress`` (JAX's order). Returns (carry, hist) with
    hist[name] a float32 array of shape ``(*runs_prefix, [n,] num_frames)``.
    """
    num_frames = len(per_frame[0])
    prefix = () if runs is None else (runs,)
    hist = {
        k: np.zeros(prefix + ((n,) if n > 1 else ()) + (num_frames,), np.float32)
        for k, n in fields
    }
    ckpt = ckpt or Checkpoint()
    start, carry = ckpt.resume(carry, hist)
    for frame in range(start, num_frames):
        carry, packed = frame_step(carry, *(p[frame] for p in per_frame))
        m = unpack_metrics(packed.cpu().numpy(), fields)  # one device-to-host copy
        for k, _ in fields:
            hist[k][..., frame] = m[k]
        if ckpt.due(frame + 1, num_frames):
            ckpt.save(frame + 1, carry, hist)
        if progress:
            progress(frame, m)
    return carry, hist
