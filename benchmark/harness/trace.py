"""The traced part of a ``--trace 1`` run, and its reduction to what the
per-layer readers take.

The kinds bracket their untraced window with ``Tracer.rest_begin()`` /
``rest_end()``, which take its seconds and the program's own launch count
of each hand-written kernel (``ops/_build.py: COUNTED``) over it. Once the
window has closed, ``start()`` / ``stop()`` bracket more units of the same
work (an experiment, or blocks of the stream) under ``torch.profiler`` with
CUDA activities (CUPTI), so that the profiler's cost stays out of the
window; ``stop`` takes the units run and the launches in the trace. The
reduction keeps every device operation (kernels, copies, sets) inside the
traced window, a host span the harness opened around it
(``bench.window``); the window's length is that span's, the busy time the
union of the device operations' intervals in it. A trace without that span
has no window, and the run fails.
"""

from __future__ import annotations

import dataclasses
import time

WINDOW_SPAN = "bench.window"
SPAN_PREFIX = "bench."  # the harness's own host spans; the profiler mirrors them on the device


def short(name: str) -> str:
    """A device operation's or host span's name without its trailing argument
    list and return type, at most 120 characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:  # a C++ signature's argument list, not a plain label's note
                name = name[:i] if "::" in name[:i] else name
                break
    return name.removeprefix("void ")[:120]


@dataclasses.dataclass
class Summary:
    """The traced window, reduced: ``ops`` [(name, start_us, end_us)] of the
    device, sorted by start; ``host`` [(name, start_us, end_us)] of host
    spans and operators; ``counters``: the units traced and the program's
    launches in the window by kernel wrapper."""

    window_s: float = 0.0
    busy_s: float = 0.0
    ops: list = dataclasses.field(default_factory=list)
    host: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)
    t0_us: float = 0.0
    t1_us: float = 0.0

    def matching(self, part: str) -> list:
        """The device operations whose name holds ``part``."""
        return [o for o in self.ops if part in o[0]]

    def intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the window."""
        merged = []
        for _, s, e in self.ops:
            s, e = max(s, self.t0_us), min(e, self.t1_us)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def breakdown(self) -> dict:
        """The device operations that took most time (by name, at most 10),
        and the longest idle gaps (at most 10), each named by the innermost
        host span or operator open at the gap's middle."""
        by_name: dict = {}
        for name, s, e in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps, prev = [], self.t0_us
        for s, e in self.intervals():
            if s > prev:
                gaps.append((prev, s))
            prev = e
        if self.t1_us > prev:
            gaps.append((prev, self.t1_us))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        named = []
        for s, e in gaps:
            mid = 0.5 * (s + e)
            covering = [h for h in self.host if h[1] <= mid < h[2] and h[0] != WINDOW_SPAN]
            label = min(covering, key=lambda h: h[2] - h[1])[0] if covering else "host idle"
            named.append([short(label), (e - s) * 1e-6])
        return {"device_ops": [[short(n), v] for n, v in top], "idle_gaps": named}


def launch_counts() -> dict:
    """The program's own launch count of each hand-written kernel, by its wrapper's name."""
    from vae_equalizer_tpu_torch.ops import _build

    return {w.__name__: w.launches for w in _build.COUNTED}


def _since(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in launch_counts().items() if v != before.get(k, 0)}


class Tracer:
    """Profiles between ``start`` and ``stop`` when on; a no-op when off."""

    def __init__(self, on: bool, device: str):
        self.on = on and device == "cuda"
        self.summary = Summary()
        self.untraced = {"seconds": 0.0, "launches": {}}
        self._prof = self._span = None

    def start(self) -> None:
        if not self.on:
            return
        import torch

        torch.cuda.synchronize()
        self._launches = launch_counts()
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._span = torch.profiler.record_function(WINDOW_SPAN)
        self._span.__enter__()

    def stop(self, units: int) -> None:
        """End the traced window (after the kind synchronized) and reduce it."""
        if not self.on or self._prof is None:
            return
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.summary = reduce(self._prof, {"units": units, "launches": _since(self._launches)})
        self._prof = None

    def rest_begin(self) -> None:
        """The untraced window opens."""
        self._rest = (time.perf_counter(), launch_counts())

    def rest_end(self) -> None:
        """The untraced window has closed (the kind synchronized): its seconds and launches."""
        t, before = self._rest
        self.untraced = {"seconds": time.perf_counter() - t, "launches": _since(before)}


def reduce(prof, counters: dict) -> Summary:
    """The profiler's events -> ``Summary``."""
    from torch.autograd import DeviceType

    from .core import Fail

    ops, host, window = [], [], None
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            if not ev.name.startswith(SPAN_PREFIX):  # a host span's mirror, not device work
                ops.append((ev.name, float(tr.start), float(tr.end)))
        elif ev.device_type == DeviceType.CPU:
            host.append((ev.name, float(tr.start), float(tr.end)))
            if ev.name == WINDOW_SPAN:
                window = (float(tr.start), float(tr.end))
    if window is None:
        raise Fail(f"the trace holds no {WINDOW_SPAN} span: no traced window to read")
    ops.sort(key=lambda o: o[1])
    host.sort(key=lambda h: h[1])
    s = Summary(window_s=(window[1] - window[0]) * 1e-6, ops=ops, host=host,
                counters=dict(counters), t0_us=window[0], t1_us=window[1])
    s.busy_s = sum(e - b for b, e in s.intervals()) * 1e-6
    return s
