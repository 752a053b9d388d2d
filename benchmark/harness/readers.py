"""What the per-layer metric readers (``benchmark/metrics/<metric>.py``)
share. A reader is ``read(t, cell)``: ``t`` the traced window's
``trace.Summary``, ``cell`` the run's cell (``config`` and ``mix`` as run,
and ``untraced``: the seconds and the program's launches by kernel wrapper
of the window, which ran before the trace). It returns a number, or None where
there is nothing to read (the harness then leaves the metric out of the
line). A metric that needs a kernel's operations or bytes brings them from
the frozen counts (``counts.py``) at the cell's shapes."""

from __future__ import annotations

from . import counts


def roofline(t, kernel: str, wrapper: str, shape: dict) -> float | None:
    """A kernel's share (%) of its roofline: the frozen bound of one launch
    of ``shape`` (``counts.bound``) over the kernel's mean device time a
    launch in the trace (events named with ``kernel``). None unless the
    trace holds every launch the program counted on ``wrapper`` (graph
    replays included; a compiled runner's warm-up launch, which the program
    does not count, may add one)."""
    ev = t.matching(kernel)
    n = t.counters.get("launches", {}).get(wrapper, 0)
    if not ev or not n <= len(ev) <= n + 1:
        return None
    mean_ms = sum(e - s for _, s, e in ev) / len(ev) * 1e-3
    return 100.0 * counts.bound(*counts.b_launch(shape))["bound_ms"] / mean_ms


def mfu(cell, wrapper: str, flops_a_launch: float) -> float | None:
    """The model's operations over the untraced window (the launches the
    program counted on ``wrapper`` times the frozen count a launch) over its
    length at the card's float32 peak, in %: the profiler's cost is not in it."""
    n, s = cell.untraced["launches"].get(wrapper, 0), cell.untraced["seconds"]
    if not n or s <= 0:
        return None
    return 100.0 * n * flops_a_launch / (s * counts.F32_FLOPS)


def idle(t, cell) -> float | None:
    """The share (%) of the traced window in which no operation ran on the
    card. The profiler's per-operation cost on the host is in the window."""
    if t.window_s <= 0 or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def kernels_per_unit(t, cell) -> float | None:
    """Device kernels in the traced window (copies and sets left out) per
    unit of work traced (a frame, or a block)."""
    units = t.counters.get("units", 0)
    kernels = [o for o in t.ops if not o[0].startswith(("Memcpy", "Memset"))]
    if not units or not kernels:
        return None
    return len(kernels) / units
