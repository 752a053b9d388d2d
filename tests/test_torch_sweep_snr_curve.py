"""The SNR curve through the port's sweep engine (``parallel/sweep.py:
run_sweep``) with the SNR axis batched into the runs, against the plain
reference of a batched sweep (``benchmark/reference/dp_vae_sweep.py``), at
a small size on the CPU: 2 SNR points x 2 repeats, 2 frames of 2,000
symbols, 64-QAM PCS, as the benchmark cell ``dp_vae.sweep_snr.r40`` runs it
at full size. Each record's frame 0 and variance are held to the reference
within the cell's own limits (``benchmark/workloads/dp_vae.sweep_snr.r40.json``),
and a record cut from another point's runs is not. The sweep's spans open
only under the profiler. The ``requires_cuda`` cases run on a card alone,
without JAX:

    python -m pytest tests/test_torch_sweep_snr_curve.py --noconftest -q
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from benchmark.reference import dp_vae_sweep as ref
from vae_equalizer_tpu_torch.parallel import sweep
from vae_equalizer_tpu_torch.parallel.sweep import point_seed, run_sweep
from vae_equalizer_tpu_torch.utils import DpConfig, profiling

ROOT = pathlib.Path(__file__).resolve().parent.parent
CELL = json.loads((ROOT / "benchmark" / "workloads" / "dp_vae.sweep_snr.r40.json").read_text())
FRAME0 = ("frame0_var_est_rel", "frame0_mi_abs", "frame0_ser_abs")
SNRS, ITERS, SEED = [16.0, 23.0], 2, 2**31 + 23
SMALL = dict(num_frames=2, n_frame_max=2000)  # 20 minibatch steps a frame


def _config():
    """The cell's configuration at the small size: the program's base
    configuration and the reference's dict."""
    cfg = json.loads((ROOT / "benchmark" / "configs" / "dp_vae_64qam_snr_curve.json").read_text())
    cfg.update(SMALL, snr_grid_db=SNRS)
    fields = {f.name for f in dataclasses.fields(DpConfig)}
    base = DpConfig(**{k: tuple(v) if k == "phi_iq" else v for k, v in cfg.items() if k in fields})
    return base, cfg


def _sweep(tmp_path, device="cpu", **kw):
    """The SNR curve at the small size, as the sweep driver runs it with
    ``--pallas-frame --batch-snr-axis``: the records in grid order."""
    base, _ = _config()
    axes = dict(snr_db=SNRS, lr=[base.lr])
    recs, _, jsonl = run_sweep("VAE", base, axes, ITERS, SEED, out_dir=tmp_path, tag="snr",
                               runner_kwargs={"use_pallas": "frame"}, batch_snr_axis=True,
                               device=device, **kw)
    return sorted(recs, key=lambda r: r["coords"]), jsonl


def _gaps(recs, want) -> dict:
    """The cell's frame-0 gaps and variance gap of records ``recs`` (grid
    order) against the reference's frame 0 ``want``, each the worst over
    points, runs and pols."""
    f32 = lambda v: np.asarray(v, np.float32)  # noqa: E731  (a JSONL line holds them as floats)
    col = lambda k: torch.as_tensor(np.concatenate([f32(r[k])[..., 0] for r in recs]))  # noqa: E731
    got = {k: col(k) for k in ("ser", "mi", "var_est")}
    var = torch.as_tensor(np.stack([f32(r["var"]) for r in recs]))
    return {
        "frame0_var_est_rel": float(((got["var_est"] - want["var_est"]).abs()
                                     / want["var_est"]).max()),
        "frame0_mi_abs": float((got["mi"] - want["mi"]).abs().max()),
        "frame0_ser_abs": float((got["ser"] - want["ser"]).abs().max()),
        "var_rel": float(((var - want["var"]).abs() / want["var"]).max()),
    }


@pytest.fixture(scope="module")
def curve(tmp_path_factory):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    recs, jsonl = _sweep(tmp_path_factory.mktemp("snr"))
    want = ref.frame0(_config()[1], ref.group_seed(SEED, 0), SNRS, ITERS, "cpu")
    return recs, jsonl, want


def test_group_seed_is_the_engines():
    for seed, i in ((SEED, 0), (7, 3), (2**40 + 1, 12)):
        assert ref.group_seed(seed, i) == point_seed(seed, i)


def test_records_hold_each_points_runs_within_the_cells_limits(curve):
    """One record a point, each with its own runs' frame 0 and its own
    demapper variance, within the cell's limits; the JSONL file holds the
    same numbers."""
    recs, jsonl, want = curve
    assert [r["coords"][0] for r in recs] == [0, 1]
    assert [r["config"]["snr_db"] for r in recs] == SNRS
    limits = CELL["limits"]
    gaps = _gaps(recs, want)
    assert all(gaps[k] <= limits[k] for k in FRAME0 + ("var_rel",)), gaps
    lines = sorted((json.loads(s) for s in jsonl.read_text().splitlines()),
                   key=lambda r: r["coords"])
    assert _gaps(lines, want) == gaps
    assert float(np.asarray(recs[0]["var"])[0]) > float(np.asarray(recs[1]["var"])[0])


def test_a_record_rolled_by_one_point_fails(curve):
    """Records whose points are rolled by one (point j holding point j + 1's
    runs, SER, MI and variance) read above the cell's limits."""
    recs, _, want = curve
    rolled = [{**r, **{k: recs[(j + 1) % len(recs)][k] for k in ("ser", "mi", "var_est", "var")}}
              for j, r in enumerate(recs)]
    gaps = _gaps(rolled, want)
    assert gaps["var_rel"] > CELL["limits"]["var_rel"], gaps
    assert any(gaps[k] > CELL["limits"][k] for k in FRAME0), gaps


def test_point_result_slices_each_points_runs():
    """``_point_result`` gives point j the runs [j iters, (j + 1) iters) of
    every history and parameter, and the variance of its first run."""
    R = 6
    res = {"ser": np.arange(R * 4 * 2.0).reshape(R, 4, 2),
           "mi": np.arange(R * 2.0).reshape(R, 2, 1), "var_est": np.zeros((R, 2, 1)),
           "var_runs": np.repeat(np.arange(3.0), 2)[:, None] * np.ones(2), "var": np.ones(2),
           "params": {"w": torch.arange(R * 1.0)}}
    for bj in range(3):
        got = sweep._point_result(res, bj, 2)
        np.testing.assert_array_equal(got["ser"], res["ser"][2 * bj : 2 * bj + 2])
        np.testing.assert_array_equal(got["var"], [bj, bj])
        assert got["params"]["w"].tolist() == [2.0 * bj, 2.0 * bj + 1]


def test_sweep_spans_only_under_the_profiler(tmp_path, monkeypatch):
    """Under ``torch.profiler``: one ``sweep.group`` around the one runner
    call (its ``dp.setup`` inside it), then one ``sweep.record`` a point after
    it; with no profiler the spans never enter it, and the records hold the
    same numbers."""
    torch.set_num_threads(min(4, torch.get_num_threads()))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on, _ = _sweep(tmp_path / "on")
    ev = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    spans = lambda name: [e.time_range for e in ev if e.name == name]  # noqa: E731
    (group,), records, setups = spans("sweep.group"), spans("sweep.record"), spans("dp.setup")
    assert len(records) == len(SNRS) and len(setups) == 1
    assert group.start <= setups[0].start and setups[0].end <= group.end
    assert all(group.end <= r.start for r in records)

    def enter(*_):
        raise AssertionError("the profiler was entered")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", enter)
    assert profiling.span("sweep.group") is profiling.span("sweep.record")
    off, _ = _sweep(tmp_path / "off")
    for a, b in zip(on, off):
        for k in ("ser", "mi", "var_est", "var"):
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.requires_cuda
def test_compiled_batched_sweep_replays_the_loop_on_the_card(tmp_path):
    """On the card, the batched SNR sweep replayed as CUDA graphs (per-run
    SNR and variance captured in the graph; kernel K over every run) gives
    the loop mode's records and parameters bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    loop, _ = _sweep(tmp_path / "loop", device="cuda", save_params=True)
    graph, _ = _sweep(tmp_path / "graph", device="cuda", save_params=True, compiled=True)
    for a, b in zip(loop, graph):
        for k in ("ser", "mi", "var_est", "var"):
            np.testing.assert_array_equal(a[k], b[k])
        with np.load(a["checkpoint"]) as pa, np.load(b["checkpoint"]) as pb:
            assert set(pa.files) == set(pb.files) == {"w", "h"}
            for k in pa.files:
                np.testing.assert_array_equal(pa[k], pb[k])
