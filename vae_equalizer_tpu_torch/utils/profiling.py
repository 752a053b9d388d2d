"""Timing and tracing hooks (port of ``vae_equalizer_tpu/utils/profiling.py:
timed, trace``).

``timed`` measures the wall time of a call with the device synchronized
(``torch.cuda.synchronize`` for the card its result lives on; nothing on
the CPU); ``trace(dir)`` wraps a block in ``torch.profiler`` and writes a
Chrome trace (chrome://tracing, Perfetto) into ``dir``. The JAX module's
``enable_compilation_cache`` and ``backend_preflight`` worked around a TPU
transport and have no counterpart here.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["timed", "trace"]


def _tensors(result) -> list:
    """The tensors in ``result`` (nested tuples, lists and dicts)."""
    if torch.is_tensor(result):
        return [result]
    if isinstance(result, dict):
        result = list(result.values())
    return [t for r in result for t in _tensors(r)] if isinstance(result, (tuple, list)) else []


def _wait(result) -> None:
    """Wait for the work behind ``result``: the cards its tensors live on
    (nothing for CPU tensors), or, where it holds no tensor, the current
    card if CUDA is in use."""
    ts = _tensors(result)
    devices = {t.device for t in ts if t.device.type == "cuda"}
    if not ts and torch.cuda.is_initialized():
        devices = {torch.device("cuda", torch.cuda.current_device())}
    for d in devices:
        torch.cuda.synchronize(d)


def timed(fn, *args, warmup: int = 1, reps: int = 5, **kwargs):
    """(median seconds, last result) of ``fn(*args, **kwargs)`` over ``reps``
    calls after ``warmup`` calls, each call's device work waited for."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
        _wait(result)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        _wait(result)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], result


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block: ``with trace("prof") as prof: step(...)``. Records
    CPU activity, and CUDA activity where a card is present, and writes a
    Chrome trace ``trace_<pid>_<ns>.json`` into ``log_dir`` when the block
    ends; yields the ``torch.profiler.profile`` (``key_averages()``)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()  # the trace holds the block's work alone
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()  # the block's device work lands in the trace
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
