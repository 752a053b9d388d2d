"""The port's spans (``utils/profiling.py: span``) at its layer boundaries.

With no profiler active a span is one shared no-op; under
``torch.profiler`` the DP runner's frame loop and the streaming receiver
emit their host ranges (``dp.*``, ``harness.*``, ``streaming.*``), nested
as the layers are, as CPU events that are not user annotations (no device
mirror), and the results are the same bits with the profiler on and off.
The ``requires_cuda`` case runs on a card alone, without JAX:

    python -m pytest tests/test_torch_spans.py --noconftest -q
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from vae_equalizer_tpu_torch.core import demapper_noise_var, make_constellation
from vae_equalizer_tpu_torch.models.streaming import StreamingReceiver
from vae_equalizer_tpu_torch.train import train_vae_dp
from vae_equalizer_tpu_torch.utils import DpConfig
from vae_equalizer_tpu_torch.utils import profiling

PREFIXES = ("dp.", "harness.", "streaming.")
CFG = DpConfig(num_frames=3, n_frame_max=1000)  # 10 minibatch steps a frame


def _profiled(fn, cuda=False):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        if cuda:
            torch.cuda.synchronize()
    return out, prof.events()


def _spans(events, name):
    return [e for e in events if e.name == name and e.device_type == DeviceType.CPU]


def _inside(inner, outers):
    r = inner.time_range
    return any(o.time_range.start <= r.start and r.end <= o.time_range.end for o in outers)


def _run(device="cpu", **kw):
    return train_vae_dp(CFG, 7, device=device, runs=2, use_pallas="frame", **kw)


def _same(a, b):
    for k in ("ser", "mi", "var_est"):
        np.testing.assert_array_equal(a[k], b[k])
    for k in ("w", "h"):
        assert torch.equal(a["params"][k], b["params"][k])


def test_span_off_is_the_shared_no_op(monkeypatch):
    def enter(*_):
        raise AssertionError("the profiler was entered")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", enter)
    assert not torch.autograd.profiler._is_profiler_enabled
    first = profiling.span("dp.train")
    assert first is profiling.span("streaming.adapt")
    with first, profiling.span("harness.frame"):
        pass


@pytest.mark.parametrize("chunk_frames", [1, 2])
def test_frame_loop_spans(chunk_frames):
    """One ``harness.frame`` a frame, each holding its channel, train and
    eval spans (a chunked run's warm-up holds one more of each inside
    ``harness.build``); one ``dp.setup`` before the first frame; the fetch
    outside the frames, one a frame or one a chunk; the same bits as
    without the profiler."""
    res, ev = _profiled(lambda: _run(chunk_frames=chunk_frames))
    frames, build = _spans(ev, "harness.frame"), _spans(ev, "harness.build")
    assert len(frames) == CFG.num_frames and len(build) == (chunk_frames > 1)
    for name in ("dp.channel", "dp.train", "dp.eval"):
        got = _spans(ev, name)
        assert len(got) == CFG.num_frames + len(build)
        assert sum(_inside(s, frames) for s in got) == CFG.num_frames
        assert all(_inside(s, frames + build) for s in got)
    (setup,) = _spans(ev, "dp.setup")
    assert setup.time_range.end <= min(f.time_range.start for f in frames + build)
    fetch = _spans(ev, "harness.fetch")
    assert len(fetch) == -(-CFG.num_frames // chunk_frames)
    assert not any(_inside(f, frames) for f in fetch)
    _same(res, _run(chunk_frames=chunk_frames))


def _stream_receiver(use_pallas):
    const = make_constellation("16-QAM", 0.0)
    var = np.full((2,), demapper_noise_var(const, 20.0), np.float32)
    return StreamingReceiver(np.asarray(const.amps, np.float32), np.asarray(const.P, np.float32),
                             var, const.nu_sc, block_len=500, use_pallas=use_pallas, device="cpu")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_streaming_spans(use_pallas):
    """Each block's ``streaming.step`` holds one ``streaming.adapt`` and one
    ``streaming.output``; the outputs are the same bits as without the
    profiler."""
    blocks = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 2, 2, 1000)).astype(np.float32))

    def run():
        rxr = _stream_receiver(use_pallas)
        state, outs = rxr.init(), []
        for blk in blocks:
            state, q, out = rxr.step(state, blk)
            outs += [q, out]
        return outs + [state["params"]["w"], state["tail"]]

    traced, ev = _profiled(run)
    steps = _spans(ev, "streaming.step")
    assert len(steps) == len(blocks)
    for name in ("streaming.adapt", "streaming.output"):
        got = _spans(ev, name)
        assert len(got) == len(blocks) and all(_inside(s, steps) for s in got)
    assert all(torch.equal(a, b) for a, b in zip(traced, run()))


def test_spans_are_host_events_without_a_mirror():
    """Every program span is a CPU event, not a user annotation, and no
    event of another device type carries a program span's name."""
    _, ev = _profiled(lambda: _run(chunk_frames=2))
    mine = [e for e in ev if e.name.startswith(PREFIXES)]
    assert {e.name for e in mine} >= {"dp.setup", "dp.channel", "dp.train", "dp.eval",
                                      "harness.build", "harness.frame", "harness.fetch"}
    assert all(e.device_type == DeviceType.CPU and not e.is_user_annotation for e in mine)


@pytest.mark.requires_cuda
def test_spans_on_the_card():
    """On the card: no CUDA-typed event has a program span's name, and
    kernel B's launch (the runtime call of the kernel's correlation id) sits
    inside ``dp.train``, in the loop mode and in the replay's capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel B is CUDA C++ (no interpret mode)")
    for compiled in (False, True):
        _, ev = _profiled(lambda: _run("cuda", compiled=compiled), cuda=True)
        assert not [e for e in ev if e.device_type != DeviceType.CPU
                    and e.name.startswith(PREFIXES)]
        train = _spans(ev, "dp.train")
        launches = {e.id: e for e in ev if e.device_type == DeviceType.CPU
                    and e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))}
        b = [e for e in ev if e.device_type == DeviceType.CUDA and "vae_dp_frame_kernel" in e.name]
        assert b
        if compiled:  # replays carry the graph launch's id: the capture's launch is in dp.train
            captured = [c for c in launches.values() if _inside(c, _spans(ev, "harness.capture"))
                        and _inside(c, train)]
            assert captured
        else:
            assert all(_inside(launches[e.id], train) for e in b)
