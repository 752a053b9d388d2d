"""The per-layer readers and the trace's reduction on made-up windows."""

import types

import pytest
from torch.autograd import DeviceType

from benchmark.harness import core, counts, readers, trace

CONFIG = core.load_json(core.BENCH / "configs" / "dp_vae_64qam.json")
MIX = {"runs": 8}


def _event(name, start, end, device):
    return types.SimpleNamespace(name=name, device_type=device,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def _prof(*events):
    return types.SimpleNamespace(events=lambda: list(events))


def test_reduce_takes_the_window_span():
    s = trace.reduce(_prof(_event(trace.WINDOW_SPAN, 0.0, 1e6, DeviceType.CPU),
                           _event("vae_dp_frame_kernel", 1e5, 3e5, DeviceType.CUDA),
                           _event("other", 2e5, 4e5, DeviceType.CUDA)), {"units": 1})
    assert s.window_s == pytest.approx(1.0) and s.busy_s == pytest.approx(0.3)
    assert readers.idle(s, None) == pytest.approx(70.0)


def test_reduce_without_the_window_span_fails():
    with pytest.raises(core.Fail, match=trace.WINDOW_SPAN):
        trace.reduce(_prof(_event("vae_dp_frame_kernel", 1e5, 3e5, DeviceType.CUDA)), {})


def test_mfu_reads_the_untraced_window_only():
    flops, _ = counts.b_launch(counts.b_experiment(CONFIG, MIX))
    ran = types.SimpleNamespace(untraced={"seconds": 2.0, "launches": {"vae_dp_frame_train": 340}})
    assert readers.mfu(ran, "vae_dp_frame_train", flops) == pytest.approx(
        100 * 340 * flops / (2.0 * counts.F32_FLOPS))
    none = types.SimpleNamespace(untraced={"seconds": 0.0, "launches": {}})
    assert readers.mfu(none, "vae_dp_frame_train", flops) is None


@pytest.mark.parametrize("events,launches,expect", [(170, 170, True), (171, 170, True),
                                                    (169, 170, False), (170, 0, False)])
def test_roofline_only_where_the_trace_holds_every_launch(events, launches, expect):
    s = trace.Summary(ops=[("vae_dp_frame_kernel", 2e3 * i, 2e3 * i + 1.9e3) for i in range(events)],
                      counters={"launches": {"vae_dp_frame_train": launches}})
    got = readers.roofline(s, "vae_dp_frame_kernel", "vae_dp_frame_train",
                           counts.b_experiment(CONFIG, MIX))
    assert (got is not None) == expect
    if expect:
        bound_ms = counts.bound(*counts.b_launch(counts.b_experiment(CONFIG, MIX)))["bound_ms"]
        assert got == pytest.approx(100 * bound_ms / 1.9)
