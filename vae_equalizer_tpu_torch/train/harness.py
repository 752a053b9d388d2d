"""Frame-loop harness (port of ``vae_equalizer_tpu/train/harness.py``, loop mode).

``frame_step(carry, *inputs) -> (carry, packed)`` is driven over the
experiment's frames from a Python loop. Each frame's metrics are packed on
the device into one float32 tensor (``pack_metrics``) and copied to the host
once, so the host waits on the device once per frame.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

__all__ = ["Progress", "pack_metrics", "unpack_metrics", "run_frame_loop"]

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


def run_frame_loop(frame_step: Callable, carry, per_frame: tuple, fields: Fields, *,
                   runs: int | None = None, progress: Progress = None):
    """Drive ``frame_step`` over frames; per_frame = sequences indexed by frame.

    Returns (carry, hist) with hist[name] a float32 array of shape
    ``(*runs_prefix, [n,] num_frames)``.
    """
    num_frames = len(per_frame[0])
    prefix = () if runs is None else (runs,)
    hist = {
        k: np.zeros(prefix + ((n,) if n > 1 else ()) + (num_frames,), np.float32)
        for k, n in fields
    }
    for frame in range(num_frames):
        carry, packed = frame_step(carry, *(p[frame] for p in per_frame))
        m = unpack_metrics(packed.cpu().numpy(), fields)  # one device-to-host copy
        for k, _ in fields:
            hist[k][..., frame] = m[k]
        if progress:
            progress(frame, m)
    return carry, hist
