"""VAEflex's frame 0 step by step: ``train_vae_flex_dp(frame0_losses=True)``
against the plain step-by-step reference
(``benchmark/reference/dp_vae_steps.py``), at a small size on the CPU: 2
runs, 2 frames of 600 symbols, 50 windows of 100 symbols every 10 a frame,
64-QAM PCS, as the benchmark cell ``dp_vaeflex.replay.r8`` runs it at full
size. Frame 0's per-step losses, noise variance estimate, SER and MI are
held to the reference within the cell's own limits
(``benchmark/workloads/dp_vaeflex.replay.r8.json``), from the Dirac start
and from seeded random butterflies, and kernel B at twice the stride (the
cell's ``windows_halved`` fault) is not. The option leaves every other
output as it was, bit for bit, in the loop and graph modes; its span opens
only under the profiler; kernel B's windows counter counts every window. The
``requires_cuda`` case runs on a card alone, without JAX:

    python -m pytest tests/test_torch_vaeflex_steps.py --noconftest -q
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from benchmark.reference import dp_vae_steps as ref
from benchmark.tests.kinds.experiment_steps import b_halved
from vae_equalizer_tpu_torch.ops import frame_kernel
from vae_equalizer_tpu_torch.train import dp, train_vae_dp, train_vae_flex_dp
from vae_equalizer_tpu_torch.utils import DpConfig, profiling

ROOT = pathlib.Path(__file__).resolve().parent.parent
CELL = json.loads((ROOT / "benchmark" / "workloads" / "dp_vaeflex.replay.r8.json").read_text())
LIMITS, WINDOWS = CELL["limits"], CELL["loss_windows"]
FRAME0 = ("frame0_var_est_rel", "frame0_mi_abs", "frame0_ser_abs", "frame0_loss_rel")
RUNS, SEED = 2, 2**31 + 29
SMALL = dict(num_frames=2, n_frame_max=600)  # (600 - 100) // 10 = 50 windows a frame
STEPS = 50
OUTPUTS = ("ser", "mi", "var_est", "var")


def _config():
    """The cell's configuration at the small size: the program's and the reference's."""
    cfg = json.loads((ROOT / "benchmark" / "configs" / "dp_vaeflex_64qam.json").read_text())
    cfg.update(SMALL)
    fields = {f.name for f in dataclasses.fields(DpConfig)}
    return DpConfig(**{k: tuple(v) if k == "phi_iq" else v for k, v in cfg.items()
                       if k in fields}), cfg


def _random_start(m: int = 25) -> dict:
    """Seeded butterflies and channel estimates near the Dirac start, a pair a run."""
    g = torch.Generator().manual_seed(11)
    w = torch.zeros(RUNS, 2, 4, m)
    w[:, 0, 0, m // 2] = w[:, 1, 1, m // 2] = 1.0
    h = torch.zeros(RUNS, 2, 2, 2, m)
    h[:, 0, 0, 0, m // 2] = h[:, 1, 1, 0, m // 2] = 1.0
    return {"w": w + 0.02 * torch.randn(w.shape, generator=g),
            "h": h + 0.02 * torch.randn(h.shape, generator=g)}


def _gaps(res: dict, want: dict) -> dict:
    """The cell's frame-0 numbers of the runner's result against the reference's."""
    got = {k: torch.as_tensor(res[k][..., 0]) for k in ("ser", "mi", "var_est")}
    losses = torch.as_tensor(res["frame0_losses"])[..., :WINDOWS]
    return {
        "frame0_var_est_rel": float(((got["var_est"] - want["var_est"]).abs()
                                     / want["var_est"].abs()).max()),
        "frame0_mi_abs": float((got["mi"] - want["mi"]).abs().max()),
        "frame0_ser_abs": float((got["ser"] - want["ser"]).abs().max()),
        "frame0_loss_rel": float(((losses - want["losses"][..., :WINDOWS]).abs()
                                  / want["losses"][..., :WINDOWS].abs()).max()),
    }


def _flex(device="cpu", **kw):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return train_vae_flex_dp(_config()[0], SEED, device=device, runs=RUNS, use_pallas="frame", **kw)


@pytest.mark.parametrize("start", ["dirac", "random"])
@pytest.mark.parametrize("mode", ["frame", False])
def test_frame0_losses_follow_the_reference(start, mode):
    """Kernel B's plain version (``"frame"``) and the autograd mode (False)
    return frame 0's 50 losses a run, within the cell's limits of the
    reference, as are frame 0's variance estimate, MI and SER."""
    params = _random_start() if start == "random" else None
    torch.set_num_threads(min(4, torch.get_num_threads()))
    res = train_vae_flex_dp(_config()[0], SEED, device="cpu", runs=RUNS, use_pallas=mode,
                            params_init=params, frame0_losses=True)
    assert res["frame0_losses"].shape == (RUNS, STEPS)
    want = ref.frame0(_config()[1], SEED, RUNS, "cpu", params=params)
    gaps = _gaps(res, want)
    assert all(gaps[k] <= LIMITS[k] for k in FRAME0), gaps


def test_windows_halved_fails(monkeypatch):
    """Kernel B at twice the window stride (half the windows, each given
    twice) reads above the cell's loss limit."""
    monkeypatch.setattr(dp, "vae_dp_frame_train", b_halved(dp.vae_dp_frame_train))
    res = _flex(frame0_losses=True)
    gaps = _gaps(res, ref.frame0(_config()[1], SEED, RUNS, "cpu"))
    assert gaps["frame0_loss_rel"] > LIMITS["frame0_loss_rel"], gaps


@pytest.mark.parametrize("graph", [{}, {"compiled": True}, {"chunk_frames": 2}])
def test_option_leaves_every_output(graph):
    """With and without ``frame0_losses``, in the loop and graph modes (the
    same step, eager on the CPU): every output bit for bit, and the losses
    the loop mode's."""
    on, off = _flex(frame0_losses=True, **graph), _flex(**graph)
    assert set(on) - set(off) == {"frame0_losses"}
    for k in OUTPUTS:
        np.testing.assert_array_equal(on[k], off[k])
    for k in ("w", "h"):
        assert torch.equal(on["params"][k], off["params"][k])
    if graph:
        loop = _flex(frame0_losses=True)
        np.testing.assert_array_equal(on["frame0_losses"], loop["frame0_losses"])


def test_one_run_without_a_runs_axis():
    """``runs=None``: the losses (steps,) of the one run."""
    cfg = _config()[0]
    res = train_vae_dp(dataclasses.replace(cfg, loss_type="VAE"), SEED, device="cpu",
                       use_pallas="frame", frame0_losses=True)
    assert res["frame0_losses"].shape == (cfg.n_frame_max // cfg.batch_len,)
    assert np.all(np.isfinite(res["frame0_losses"]))


def test_losses_span_only_under_the_profiler(monkeypatch):
    """Under ``torch.profiler``: one ``dp.losses`` a frame, inside that
    frame's ``dp.train``; with no profiler the span never enters it."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _flex(frame0_losses=True)
    ev = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    spans = lambda name: [e.time_range for e in ev if e.name == name]  # noqa: E731
    losses, trains = spans("dp.losses"), spans("dp.train")
    assert len(losses) == len(trains) == SMALL["num_frames"]
    assert all(t.start <= s.start and s.end <= t.end for s, t in zip(losses, trains))

    def enter(*_):
        raise AssertionError("the profiler was entered")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", enter)
    assert profiling.span("dp.losses") is profiling.span("dp.train")
    _flex(frame0_losses=True)


def test_windows_counted_by_kernel_b(monkeypatch):
    """Kernel B's launch code on the host emulation (``ops/_build.py:
    host_library``) through the runner: one launch and 50 windows a frame
    in ``COUNTED``, and frame 0 within the cell's limits of the reference."""
    from kernel_emulation import emulate, host_lib

    emulate(monkeypatch, host_lib("dp"))
    monkeypatch.setattr(frame_kernel.WINDOWS, "launches", 0)
    monkeypatch.setattr(frame_kernel.vae_dp_frame_train, "launches", 0)

    def launched(w, h, opt, rx, amps, var, nu_sc, P, lr, step0, lr_half_step, *, bl_sym,
                 stride_sym=None, stream_bf16=False):
        return frame_kernel._launch(w, h, opt, rx, amps, var, nu_sc, P, lr, step0, lr_half_step,
                                    bl_sym, stride_sym, stream_bf16)

    monkeypatch.setattr(dp, "vae_dp_frame_train", launched)
    got = _flex(frame0_losses=True)
    counts = {c.__name__: c.launches
              for c in (frame_kernel.vae_dp_frame_train, frame_kernel.WINDOWS)}
    assert counts == {"vae_dp_frame_train": 2, "vae_dp_frame_windows": 2 * STEPS}, counts
    gaps = _gaps(got, ref.frame0(_config()[1], SEED, RUNS, "cpu"))
    assert all(gaps[k] <= LIMITS[k] for k in FRAME0), gaps


@pytest.mark.requires_cuda
def test_replayed_losses_on_the_card():
    """On the card, the experiment replayed as a CUDA graph: the losses and
    every output equal the loop mode's bit for bit, the option leaves every
    output as it was, kernel B counts 50 windows a replay, and frame 0's
    losses lie within the cell's limit of the reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    before = frame_kernel.WINDOWS.launches
    graph = _flex("cuda", compiled=True, frame0_losses=True)
    assert frame_kernel.WINDOWS.launches - before == SMALL["num_frames"] * STEPS
    loop, off = _flex("cuda", frame0_losses=True), _flex("cuda", compiled=True)
    for k in OUTPUTS + ("frame0_losses",):
        np.testing.assert_array_equal(graph[k], loop[k])
    for k in OUTPUTS:
        np.testing.assert_array_equal(graph[k], off[k])
    want = ref.frame0(_config()[1], SEED, RUNS, "cuda")
    gaps = _gaps(graph, {k: v.cpu() for k, v in want.items()})
    assert all(gaps[k] <= LIMITS[k] for k in FRAME0), gaps
