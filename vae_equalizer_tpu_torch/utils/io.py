"""Results IO: incremental JSONL records, the reference's .mat layout, .npz
checkpoints.

Port of ``vae_equalizer_tpu/utils/io.py`` (numpy and scipy only, no JAX):
every grid point of a sweep appends one JSONL record as soon as it finishes,
and the .mat export (the reference's ``savemat({"dict": {...}})`` layout,
Eval_run_DP.py:99-114) is re-derivable from the JSONL at any time.
Checkpoints are flat .npz files of nested dicts of arrays. Torch tensors, on
the CPU or the card, are accepted wherever arrays are.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time

import numpy as np
import torch

__all__ = ["append_jsonl", "read_jsonl", "save_mat", "save_checkpoint", "load_checkpoint"]


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _to_jsonable(x):
    if isinstance(x, (np.ndarray, np.generic, torch.Tensor)):
        return _to_numpy(x).tolist()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.asdict(x)
    if isinstance(x, dict):
        return {k: _to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_jsonable(v) for v in x]
    return x


def append_jsonl(path: str | pathlib.Path, record: dict) -> None:
    """Append one result record (atomic enough for single-writer sweeps)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    record = {"ts": time.time(), **_to_jsonable(record)}
    with path.open("a") as f:
        f.write(json.dumps(record) + "\n")


def read_jsonl(path: str | pathlib.Path) -> list[dict]:
    with pathlib.Path(path).open() as f:
        return [json.loads(line) for line in f if line.strip()]


def save_mat(path: str | pathlib.Path, save_dict: dict) -> None:
    """scipy .mat export with the reference's {'dict': {...}} layout."""
    import scipy.io as sio

    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    sio.savemat(str(path), {"dict": {k: _to_numpy(v) for k, v in save_dict.items()}})


def save_checkpoint(path: str | pathlib.Path, tree: dict) -> None:
    """Flatten a nested dict of arrays into one .npz ("a/b" keys)."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}/", v)
        else:
            flat[prefix.rstrip("/")] = _to_numpy(node)

    walk("", tree)
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)


def load_checkpoint(path: str | pathlib.Path) -> dict:
    """Inverse of save_checkpoint: nested dict of numpy arrays."""
    flat = dict(np.load(pathlib.Path(path)))
    tree: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree
