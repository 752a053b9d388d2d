"""Device time and host time by the program's own spans
(``vae_equalizer_tpu_torch/utils/profiling.py: span``).

The program marks its layers with host ranges (``dp.*``, ``harness.*``,
``streaming.*``) on the profiler's clock, so a ``trace.Summary`` holds them
among its host events. The trace links no device operation to its launch,
so ``attribute`` matches them by order: the card runs the program's work in
the order the host launched it (one stream, or streams that wait on each
other), so the k-th device operation belongs to the k-th launch call
(``LAUNCHES``). A launch call between ``cudaStreamBeginCapture`` and
``cudaStreamEndCapture`` is recorded into a CUDA graph and runs nothing;
a ``cudaGraphLaunch`` stands for the calls of the last capture, in capture
order (a one-stream capture is a chain of nodes). Each operation takes the
innermost program span its launch call sat in (for a replay, the span its
captured call sat in), and counts towards a frame where that call, or the
graph launch, ran inside ``harness.frame``. Where the counts disagree,
nothing is attributed.
"""

from __future__ import annotations

PREFIXES = ("dp.", "harness.", "streaming.")  # the program's spans
# host calls that each put one operation on the card
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset")
GRAPH_LAUNCH = "cudaGraphLaunch"
BEGIN_CAPTURE, END_CAPTURE = "cudaStreamBeginCapture", "cudaStreamEndCapture"
FRAME = "harness.frame"


def _open_spans(t) -> list:
    """Each host event with the program spans open at its start, outermost
    first: [(name, (span names...))], in ``t.host``'s order (by start)."""
    out, stack = [], []  # stack of (name, end)
    for name, s, e in t.host:
        while stack and stack[-1][1] <= s:
            stack.pop()
        out.append((name, tuple(n for n, _ in stack)))
        if name.startswith(PREFIXES):
            stack.append((name, e))
    return out


def attribute(t) -> list | None:
    """[(span, in_frame)] for each device operation of ``t.ops``, in its
    order: the innermost program span its launch call sat in ("" for none)
    and whether it counts towards a frame; None where the launch calls do
    not account for every operation, or a graph is launched before any
    capture."""
    calls, captured, capturing = [], None, False
    for name, open_ in _open_spans(t):
        if name == BEGIN_CAPTURE:
            captured, capturing = [], True
        elif name == END_CAPTURE:
            capturing = False
        elif name.startswith(LAUNCHES):
            inner = open_[-1] if open_ else ""
            if capturing:
                captured.append(inner)
            else:
                calls.append((inner, FRAME in open_))
        elif name == GRAPH_LAUNCH:
            if captured is None:
                return None
            calls.extend((span, FRAME in open_) for span in captured)
    return calls if len(calls) == len(t.ops) else None


def device_ms_per_unit(t, span: str) -> float | None:
    """The device time (ms) of the frames' operations launched under
    ``span`` (its self time: an operation of a span nested inside counts
    for that one), over the units traced; None where nothing is attributed
    or no operation ran in a frame."""
    att, units = attribute(t), t.counters.get("units", 0)
    if not att or not units or not any(in_frame for _, in_frame in att):
        return None
    ms = sum(e - s for (name, in_frame), (_, s, e) in zip(att, t.ops)
             if in_frame and name == span) * 1e-3
    return ms / units


def mean_host_ms(t, span: str) -> float | None:
    """The mean host length (ms) of the spans named ``span``; None without one."""
    lengths = [e - s for name, s, e in t.host if name == span]
    return sum(lengths) / len(lengths) * 1e-3 if lengths else None
