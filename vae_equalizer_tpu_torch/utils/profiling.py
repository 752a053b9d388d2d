"""Timing and tracing hooks (port of ``vae_equalizer_tpu/utils/profiling.py:
timed, trace``), and the program's spans.

``timed`` measures the wall time of a call with the device synchronized
(``torch.cuda.synchronize`` for the card its result lives on; nothing on
the CPU); ``trace(dir)`` wraps a block in ``torch.profiler`` and writes a
Chrome trace (chrome://tracing, Perfetto) into ``dir``. The JAX module's
``enable_compilation_cache`` and ``backend_preflight`` worked around a TPU
transport and have no counterpart here.

``span(name)`` marks a layer of the program on the profiler's clock: a host
range, nested by the ranges open around it, beside the card's kernels in
the same trace. ``with trace("prof"): train_vae_dp(...)`` shows them in
Perfetto; any ``torch.profiler`` session sees them. With no profiler active
a span costs one flag test and records nothing; the spans keep nothing of
their own (the profiler holds them and writes them out when its session
ends). They are host-only ranges (no device mirror, unlike
``torch.profiler.record_function``), so device time in a trace stays device
work. Under a CUDA graph a span inside the captured step runs once, at the
capture, and not at each replay. The spans:

* ``dp.setup`` (``train/dp.py``): a VAE / VAEflex call's set-up before its
  frame loop: options, constellation, simulator, run constants, the carry;
* ``dp.channel``: a frame's draws and channel physics;
* ``dp.train``: a frame's training: kernel B's launches and their joins,
  or the per-step modes' steps with Adam;
* ``dp.losses`` (inside ``dp.train``): with ``frame0_losses``, the copy of
  frame 0's per-step losses into the runner's device buffer;
* ``dp.eval``: a frame's eval (sync, SER, MI, packed metrics);
* ``harness.build`` (``train/harness.py: StepGraphs.build``): warm-up and
  capture, with ``harness.capture``, the capture itself, inside it;
* ``harness.frame``: one frame of a frame loop: the eager step, or one
  graph replay;
* ``harness.fetch``: a loop's device-to-host copy of its history rows and
  their unpacking;
* ``streaming.step`` (``models/streaming.py``): one block, with
  ``streaming.adapt`` (the adaptation) and ``streaming.output`` (the output
  pass) inside it.
* ``sweep.group`` (``parallel/sweep.py: run_sweep``): one runner call of a
  sweep (a group of grid points batched into the runs, or one point), with
  the runner's spans inside it;
* ``sweep.record``: one grid point's record: its share of the call's
  result, the JSONL append and its parameter file.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["span", "timed", "trace"]

_OFF = contextlib.nullcontext()  # every span while no profiler is active
_profiler = torch.autograd.profiler  # its flag is read anew at each span


def span(name: str):
    """A context manager marking ``name`` on the profiler's clock while a
    ``torch.profiler`` session is active, else a shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


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
