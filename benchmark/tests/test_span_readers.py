"""The readers of the program's spans (``harness/spans.py`` and the metrics
that use it) on made-up traced windows."""

import types

import pytest

from benchmark.harness import core, spans, trace

LAUNCH, GRAPH = "cudaLaunchKernel", "cudaGraphLaunch"


def _summary(host, ops, units):
    """A traced window: ``host`` [(name, start_us, end_us)] and device ``ops``
    [(name, start_us, length_us)], each sorted by start as ``trace.reduce``
    leaves them."""
    return trace.Summary(host=sorted(host, key=lambda h: h[1]),
                         ops=[(n, s, s + d) for n, s, d in sorted(ops, key=lambda o: o[1])],
                         counters={"units": units})


def _eager_frames(frames=2, t0=0.0):
    """Loop-mode frames: in each ``harness.frame``, a channel launch, a train
    launch and copy, an eval launch and the harness's own launch, then a
    ``harness.fetch`` copy outside the frame. Device lengths 1, 10 and 2, 3, 0.5, 0.25 us."""
    host, ops = [], []
    for f in range(frames):
        b = t0 + 100.0 * f
        host += [("harness.frame", b, b + 80), ("dp.channel", b + 1, b + 10), (LAUNCH, b + 2, b + 3),
                 ("dp.train", b + 10, b + 40), (LAUNCH, b + 11, b + 12),
                 ("cudaMemcpyAsync", b + 20, b + 21), ("dp.eval", b + 40, b + 70),
                 (LAUNCH, b + 41, b + 42), (LAUNCH, b + 75, b + 76),
                 ("harness.fetch", b + 80, b + 95), ("cudaMemcpyAsync", b + 81, b + 90)]
        # the card runs late, in launch order
        ops += [("channel_k", b + 30, 1.0), ("train_k", b + 32, 10.0), ("Memcpy DtoD", b + 43, 2.0),
                ("eval_k", b + 46, 3.0), ("own_k", b + 50, 0.5), ("Memcpy DtoH", b + 82, 0.25)]
    return host, ops


def _replayed_frames(frames=3):
    """A build (a warm-up of the step, then its capture, with one eager
    prologue launch before the capture begins), then replays: each
    ``harness.frame`` launches one eager kernel and the graph."""
    host = [("harness.build", 0.0, 100.0), ("dp.channel", 1, 5), (LAUNCH, 2, 3),
            ("dp.train", 5, 9), (LAUNCH, 6, 7), ("dp.eval", 9, 13), (LAUNCH, 10, 11),
            ("harness.capture", 20, 90), (LAUNCH, 21, 22), ("cudaStreamBeginCapture", 25, 26),
            ("dp.channel", 30, 40), (LAUNCH, 31, 32), ("dp.train", 40, 50), (LAUNCH, 41, 42),
            ("dp.eval", 50, 60), (LAUNCH, 51, 52), ("cudaMemcpyAsync", 53, 54), (LAUNCH, 61, 62),
            ("cudaStreamEndCapture", 70, 71)]
    ops = [("channel_k", 3, 100.0), ("train_k", 110, 100.0), ("eval_k", 220, 100.0),
           ("fill_k", 330, 100.0)]  # the warm-up and the prologue: not frames
    for f in range(frames):
        b = 1000.0 * (f + 1)
        host += [("harness.frame", b, b + 50), (LAUNCH, b + 1, b + 2), (GRAPH, b + 10, b + 40)]
        ops += [("fill_k", b + 5, 0.5), ("channel_k", b + 50, 1.0), ("train_k", b + 52, 10.0),
                ("eval_k", b + 63, 3.0), ("Memcpy DtoD", b + 67, 2.0), ("own_k", b + 70, 0.25)]
    return host, ops


def test_eager_operations_matched_by_order():
    t = _summary(*_eager_frames(), units=2)
    att = spans.attribute(t)
    assert att[:6] == [("dp.channel", True), ("dp.train", True), ("dp.train", True),
                       ("dp.eval", True), ("harness.frame", True), ("harness.fetch", False)]
    assert att[6:] == att[:6]
    assert spans.device_ms_per_unit(t, "dp.channel") == pytest.approx(1e-3)
    assert spans.device_ms_per_unit(t, "dp.train") == pytest.approx(12e-3)
    assert spans.device_ms_per_unit(t, "dp.eval") == pytest.approx(3e-3)


def test_graph_replays_expand_by_capture_order():
    t = _summary(*_replayed_frames(3), units=3)
    att = spans.attribute(t)
    assert att[:4] == [("dp.channel", False), ("dp.train", False), ("dp.eval", False),
                       ("harness.capture", False)]
    frame = [("harness.frame", True), ("dp.channel", True), ("dp.train", True), ("dp.eval", True),
             ("dp.eval", True), ("harness.capture", True)]
    assert att[4:] == frame * 3


def test_warm_up_operations_left_out_of_the_frames():
    t = _summary(*_replayed_frames(3), units=3)
    assert spans.device_ms_per_unit(t, "dp.channel") == pytest.approx(1e-3)
    assert spans.device_ms_per_unit(t, "dp.train") == pytest.approx(10e-3)
    assert spans.device_ms_per_unit(t, "dp.eval") == pytest.approx(5e-3)
    frames_ms = sum(e - s for (_, fr), (_, s, e) in zip(spans.attribute(t), t.ops) if fr) * 1e-3 / 3
    parts = sum(spans.device_ms_per_unit(t, n) for n in
                ("dp.channel", "dp.train", "dp.eval", "harness.capture", "harness.frame"))
    assert parts == pytest.approx(frames_ms) and frames_ms == pytest.approx(16.75e-3)


def test_self_time_of_nested_spans():
    """An operation counts for the innermost span its launch sat in: the
    frame keeps only its own (0.5 us a frame), not its children's."""
    t = _summary(*_eager_frames(), units=2)
    assert spans.device_ms_per_unit(t, "harness.frame") == pytest.approx(0.5e-3)
    assert spans.device_ms_per_unit(t, "harness.fetch") == 0.0  # outside the frames


@pytest.mark.parametrize("fault", ["extra_op", "missing_op", "no_frame_span", "no_capture"])
def test_none_where_matching_fails(fault):
    host, ops = _replayed_frames(2) if fault == "no_capture" else _eager_frames()
    if fault == "extra_op":
        ops.append(("stray_k", 1e4, 1.0))
    elif fault == "missing_op":
        ops.pop()
    elif fault == "no_frame_span":
        host = [h for h in host if h[0] != "harness.frame"]
    else:
        host = [h for h in host if not h[0].startswith("cudaStream")]
        ops = [o for o in ops if o[1] >= 1000]
    t = _summary(host, ops, units=2)
    for name in ("dp.channel", "dp.train", "dp.eval"):
        assert spans.device_ms_per_unit(t, name) is None


def test_mean_host_ms():
    host, ops = _eager_frames(3)
    t = _summary(host + [("streaming.adapt", 0, 300), ("streaming.adapt", 500, 600)], ops, units=3)
    assert spans.mean_host_ms(t, "harness.frame") == pytest.approx(80e-3)
    assert spans.mean_host_ms(t, "streaming.adapt") == pytest.approx(200e-3)
    assert spans.mean_host_ms(t, "harness.build") is None


NEW = {"dp.channel.device_ms_per_frame": 1e-3, "dp.train.device_ms_per_frame": 10e-3,
       "dp.eval.device_ms_per_frame": 5e-3, "harness.frame.host_ms": 50e-3,
       "harness.build.host_ms": 100e-3, "dp.setup.host_ms": 7e-3,
       "streaming.adapt.host_ms": 0.3, "streaming.output.host_ms": 0.1}


def _cell_window(workload):
    """A made-up window of the cell's shape: 170 replayed frames after a
    set-up and a build, or 2,000 blocks of the stream."""
    if workload == "dp_vae.stream.b2000":
        host, ops = [], []
        for b in range(2000):
            t0 = 1000.0 * b
            host += [("streaming.step", t0, t0 + 500), ("streaming.adapt", t0 + 10, t0 + 310),
                     (LAUNCH, t0 + 20, t0 + 21), (LAUNCH, t0 + 30, t0 + 31),
                     ("streaming.output", t0 + 350, t0 + 450), (LAUNCH, t0 + 360, t0 + 361),
                     (LAUNCH, t0 + 370, t0 + 371)]
            ops += [("fill", t0 + 40, 1.0), ("vae_dp_frame_kernel", t0 + 50, 380.0),
                    ("cat", t0 + 440, 2.0), ("butterfly_demap_kernel", t0 + 450, 3.0)]
        return _summary(host, ops, units=2000)
    host, ops = _replayed_frames(170)
    return _summary(host + [("dp.setup", -20.0, -13.0)], ops, units=170)


@pytest.mark.parametrize("workload", ["dp_vae.replay.r8", "dp_vae.loop.r8", "dp_vae.stream.b2000"])
def test_each_new_metric_reads_its_cells(workload):
    """Each new reader gives its number in every cell its entry lists, and
    nothing on a window without the program's spans (a program that has none)."""
    man = core.manifest()
    listed = {m["name"] for m in core.metrics_of(man, workload, trace=True)}
    spec = core.cell_spec(man, workload)
    ran = types.SimpleNamespace(config=spec["config"], mix=spec["mix"], untraced={})
    t = _cell_window(workload)
    bare = _summary([h for h in t.host if not h[0].startswith(spans.PREFIXES)],
                    [(n, s, e - s) for n, s, e in t.ops], t.counters["units"])
    for name, want in NEW.items():
        read = core.load_module(core.BENCH / "metrics" / f"{name}.py",
                                "m_" + name.replace(".", "_")).read
        if name in listed:
            assert read(t, ran) == pytest.approx(want), name
        assert read(bare, ran) is None, name
    assert listed & set(NEW)
