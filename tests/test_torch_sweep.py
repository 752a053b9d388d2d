"""The port's sweep engine (``parallel/sweep.py``) and results IO
(``utils/io.py``) against the JAX package's, on the CPU.

``expand_grid`` and ``assemble_mat`` are held to JAX's on the same grid and
the same records. ``run_sweep`` drives the port's ``train_vae_dp("frame")``
at a tiny size (4-QAM, 200-symbol frames, 2 frames): the lr / SNR / nu axis
batching makes one runner call per group, as JAX's ``test_sweep_batch_*``
count it, with one record per point; resume skips finished points and gives
the rest the seeds of an uninterrupted sweep.
"""

import dataclasses
import json

import numpy as np
import pytest
import scipy.io as sio
import torch

from vae_equalizer_tpu.parallel.sweep import assemble_mat as j_assemble_mat
from vae_equalizer_tpu.parallel.sweep import expand_grid as j_expand_grid
from vae_equalizer_tpu.utils.config import DpConfig as JDpConfig
from vae_equalizer_tpu_torch.core import demapper_noise_var, make_constellation
from vae_equalizer_tpu_torch.parallel import sweep
from vae_equalizer_tpu_torch.parallel.sweep import assemble_mat, expand_grid, point_seed, run_sweep
from vae_equalizer_tpu_torch.utils import DpConfig, io

torch.set_num_threads(1)

TINY = dict(mod="4-QAM", snr_db=20.0, num_frames=2, n_frame_max=200, batch_len=50, m_est=9,
            n_lrhalf=10**6)
FRAME = {"use_pallas": "frame"}


def test_expand_grid_matches_jax():
    axes = dict(snr_db=[20.0, 24.0], nu=[0.0], lr=[1e-3, 5e-3, 7e-3])
    cfgs, coords, ax = expand_grid(DpConfig(), **axes)
    j_cfgs, j_coords, j_ax = j_expand_grid(JDpConfig(), **axes)
    assert coords == j_coords and ax == j_ax and list(ax) == ["snr_db", "nu", "lr"]
    assert [dataclasses.asdict(c) for c in cfgs] == [dataclasses.asdict(c) for c in j_cfgs]
    assert len(cfgs) == 6 and cfgs[-1].lr == 7e-3 and coords[-1] == (1, 0, 2)


def test_assemble_mat_matches_jax():
    rng = np.random.default_rng(0)
    axes = {"snr_db": [20.0, 24.0], "lr": [1e-3, 2e-3, 3e-3]}
    recs = [{"coords": [i, j], "ser": rng.random((2, 4, 5)).astype(np.float32),
             "var_est": rng.random((2, 2, 5)).astype(np.float32),
             "var": rng.random(2).astype(np.float32)}
            for i in range(2) for j in range(3) if (i, j) != (1, 2)]  # one point missing
    for lead, key in (((4,), "ser"), ((2,), "var_est"), ((2,), "var")):
        got, want = assemble_mat(recs, axes, 2, lead, key), j_assemble_mat(recs, axes, 2, lead, key)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert assemble_mat(recs, axes, 2, (2,), "mi") is None and j_assemble_mat(recs, axes, 2, (2,), "mi") is None


def _counting(monkeypatch, name="VAE"):
    calls = []
    real = sweep.RUNNERS[name]

    def counting(cfg, seed, **kw):
        calls.append((cfg, seed, kw))
        return real(cfg, seed, **kw)

    monkeypatch.setitem(sweep.RUNNERS, name, counting)
    return calls


def test_batch_lr_axis_is_one_call(monkeypatch, tmp_path):
    calls = _counting(monkeypatch)
    results, axes_values, jsonl = run_sweep(
        "VAE", DpConfig(**TINY), {"snr_db": [20.0], "lr": [2.5e-3, 1e-3]}, iters=2, seed=3,
        out_dir=tmp_path, tag="b", runner_kwargs=FRAME, batch_lr_axis=True, device="cpu")
    assert len(calls) == 1  # the whole lr axis ran as one call of 2 x 2 runs
    assert calls[0][2]["runs"] == 4 and list(calls[0][2]["lr_vec"]) == [2.5e-3] * 2 + [1e-3] * 2
    assert len(results) == 2 and len(jsonl.read_text().splitlines()) == 2
    for rec, lr in zip(results, [2.5e-3, 1e-3]):
        assert rec["config"]["lr"] == lr and rec["runner_kwargs"] == FRAME
        assert np.asarray(rec["ser"]).shape == (2, 4, 2) and np.all(np.isfinite(rec["ser"]))
    assert not np.allclose(results[0]["ser"], results[1]["ser"])
    assert assemble_mat(results, axes_values, 2, (4,)).shape == (4, 1, 2, 2, 2)


def test_batch_lr_and_snr_axes_keep_each_points_var(monkeypatch, tmp_path):
    calls = _counting(monkeypatch)
    results, axes_values, _ = run_sweep(
        "VAE", DpConfig(**TINY), {"snr_db": [20.0, 14.0], "lr": [2.5e-3, 1e-3]}, iters=1, seed=9,
        out_dir=tmp_path, tag="bs", runner_kwargs=FRAME, batch_lr_axis=True, batch_snr_axis=True,
        device="cpu")
    assert len(calls) == 1 and calls[0][2]["runs"] == 4  # the 2 x 2 grid in one call
    const = make_constellation("4-QAM")
    for rec in results:
        want = np.float32(demapper_noise_var(const, rec["config"]["snr_db"]))
        np.testing.assert_array_equal(rec["var"], np.full(2, want))
    var_mat = assemble_mat(results, axes_values, 1, (2,), key="var")
    assert var_mat.shape == (2, 2, 2, 1, 1) and np.all(var_mat[:, 1] > var_mat[:, 0])


def test_batch_nu_axis_keeps_each_points_var(monkeypatch, tmp_path):
    calls = _counting(monkeypatch)
    base = DpConfig(**{**TINY, "mod": "16-QAM"})
    results, axes_values, _ = run_sweep(
        "VAE", base, {"nu": [0.0, 0.0270955]}, iters=2, seed=11, out_dir=tmp_path, tag="bn",
        runner_kwargs=FRAME, batch_nu_axis=True, device="cpu")
    assert len(calls) == 1 and len(results) == 2
    for rec in results:
        want = demapper_noise_var(make_constellation("16-QAM", rec["config"]["nu"]), base.snr_db)
        np.testing.assert_array_equal(rec["var"], np.full(2, np.float32(want)))
    assert assemble_mat(results, axes_values, 2, (4,)).shape == (4, 2, 2, 2)


def test_resume_skips_done_points_with_the_same_seeds(monkeypatch, tmp_path):
    """A sweep killed after its first point resumes at the second: the
    finished point is not rerun, and the rest get the seeds (and the results)
    of the uninterrupted sweep; a record of another runner mode is rerun."""
    axes = {"lr": [2.5e-3, 1e-3, 3e-3]}
    kw = dict(iters=1, seed=5, runner_kwargs=FRAME, device="cpu")
    full, _, _ = run_sweep("VAE", DpConfig(**TINY), axes, out_dir=tmp_path / "a", **kw)
    real, started = sweep.RUNNERS["VAE"], []

    def dies_at_second_point(cfg, seed, **k):
        started.append(seed)
        if len(started) == 2:
            raise KeyboardInterrupt
        return real(cfg, seed, **k)

    monkeypatch.setitem(sweep.RUNNERS, "VAE", dies_at_second_point)
    with pytest.raises(KeyboardInterrupt):
        run_sweep("VAE", DpConfig(**TINY), axes, out_dir=tmp_path / "b", **kw)
    monkeypatch.setitem(sweep.RUNNERS, "VAE", real)
    calls = _counting(monkeypatch)
    resumed, _, jsonl = run_sweep("VAE", DpConfig(**TINY), axes, out_dir=tmp_path / "b",
                                  skip_done=True, **kw)
    assert [c[1] for c in calls] == [point_seed(5, 1), point_seed(5, 2)]
    assert len(io.read_jsonl(jsonl)) == 3
    by_lr = {r["config"]["lr"]: np.asarray(r["ser"]) for r in resumed}
    for rec in full:
        np.testing.assert_array_equal(by_lr[rec["config"]["lr"]], rec["ser"])
    calls.clear()
    run_sweep("VAE", DpConfig(**TINY), axes, out_dir=tmp_path / "b", skip_done=True,
              **{**kw, "runner_kwargs": {"use_pallas": True}})
    assert len(calls) == 3  # finished with "frame": not a finished point of use_pallas=True
    assert len({point_seed(5, i) for i in range(50)}) == 50


def test_io_round_trips_torch_and_numpy(tmp_path):
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3), "h": np.ones((2, 2), np.float32)},
            "taps": torch.zeros(3)}
    io.save_checkpoint(tmp_path / "ck.npz", tree)
    back = io.load_checkpoint(tmp_path / "ck.npz")
    np.testing.assert_array_equal(back["params"]["w"], tree["params"]["w"].numpy())
    np.testing.assert_array_equal(back["params"]["h"], tree["params"]["h"])
    io.append_jsonl(tmp_path / "r.jsonl", {"ser": torch.tensor([0.5, 0.25]), "cfg": DpConfig()})
    rec = io.read_jsonl(tmp_path / "r.jsonl")[0]
    assert rec["ser"] == [0.5, 0.25] and rec["cfg"]["mod"] == "64-QAM" and "ts" in rec
    json.dumps(rec)
    io.save_mat(tmp_path / "m.mat", {"SER": torch.ones(4, 2), "SNR": [23.0]})
    d = sio.loadmat(tmp_path / "m.mat")["dict"]
    assert d["SER"][0, 0].shape == (4, 2) and d["SNR"][0, 0].shape == (1, 1)


def test_unported_runners_and_checkpoints_raise(monkeypatch, tmp_path):
    """The SP runners are not ported; ``checkpoint_every`` gives a point its
    state file, which the runner writes and the sweep removes when the point
    finishes; batched axes still refuse it (JAX's ValueError)."""
    for name in ("VAE-SP", "VAEflex-SP"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            run_sweep(name, DpConfig(**TINY), {"lr": [1e-3]}, 1, 0, out_dir=tmp_path, device="cpu")
    real, seen = sweep.RUNNERS["VAE"], []

    def runner(cfg, seed, **kw):
        res = real(cfg, seed, **kw)
        seen.append((kw["checkpoint"], kw["checkpoint"].exists(), kw["checkpoint_every"]))
        return res

    monkeypatch.setitem(sweep.RUNNERS, "VAE", runner)
    results, _, _ = run_sweep("VAE", DpConfig(**TINY), {"lr": [1e-3]}, 1, 0, out_dir=tmp_path,
                              tag="ck", device="cpu", checkpoint_every=1)
    ((state, made, every),) = seen
    assert made and every == 1 and state.parent == tmp_path and not state.exists()
    assert state.name.startswith("state_ck_0_") and len(state.stem) == len("state_ck_0_") + 10
    assert len(results) == 1 and np.all(np.isfinite(results[0]["ser"]))
    with pytest.raises(ValueError, match="incompatible with checkpoint_every"):
        run_sweep("VAE", DpConfig(**TINY), {"lr": [1e-3, 2e-3]}, 1, 0, out_dir=tmp_path,
                  device="cpu", runner_kwargs=FRAME, batch_lr_axis=True, checkpoint_every=1)
    with pytest.raises(ValueError, match="has no lr_vec support"):
        run_sweep("CMAbatch", DpConfig(**{**TINY, "loss_type": "CMAbatch"}), {"lr": [1e-3, 2e-3]},
                  1, 0, out_dir=tmp_path, device="cpu", batch_lr_axis=True)


def test_sweep_resume_mid_grid_and_mid_point(tmp_path):
    """skip_done + checkpoint_every (JAX tests/test_sweep.py:113): a killed
    sweep resumes past its finished grid point AND inside the interrupted
    one, and the final .mat tensor equals an uninterrupted sweep's, bit for
    bit."""
    base = DpConfig(**{**TINY, "num_frames": 6})
    axes = {"lr": [2.5e-3, 2e-3]}
    kw = dict(iters=2, seed=5, tag="t", checkpoint_every=2, device="cpu")
    ref_results, axes_values, _ = run_sweep("VAE", base, axes, out_dir=tmp_path / "ref", **kw)

    class Boom(RuntimeError):
        pass

    calls = {"n": 0}

    def killer(frame, m):
        calls["n"] += 1
        if calls["n"] == 10:  # inside grid point 2 (6 frames each), after its save at frame 2
            raise Boom()

    out = tmp_path / "resumable"
    with pytest.raises(Boom):
        run_sweep("VAE", base, axes, out_dir=out, progress=killer, **kw)
    assert len(list(out.glob("state_t_*.npz"))) == 1  # point 2 left its state
    results, axes_values2, _ = run_sweep("VAE", base, axes, out_dir=out, skip_done=True, **kw)
    assert len(results) == 2
    assert not list(out.glob("state_t_*"))  # removed once the point finished
    np.testing.assert_array_equal(assemble_mat(results, axes_values2, 2, (4,)),
                                  assemble_mat(ref_results, axes_values, 2, (4,)))


def test_sweep_resume_rejects_other_runner_mode(monkeypatch, tmp_path):
    """A grid point finished in one runner mode does not satisfy a skip_done
    resume in another (JAX tests/test_sweep.py:160), and a point's state
    file is never loaded by another mode: runner_kwargs are part of the
    state file's hash."""
    base = DpConfig(**TINY)
    axes = {"lr": [2.5e-3]}
    out = tmp_path / "s"
    kw = dict(iters=1, seed=6, out_dir=out, tag="t", device="cpu")
    r1, _, jsonl1 = run_sweep("VAE", base, axes, **kw)
    assert r1[0]["runner_kwargs"] == {}
    r2, _, jsonl2 = run_sweep("VAE", base, axes, skip_done=True, **kw)  # same mode: skipped
    assert jsonl2 == jsonl1 and r2[0] is not r1[0] and r2[0]["coords"] == [0]
    assert r2[0]["wall_s"] == r1[0]["wall_s"]  # not re-run
    r3, _, _ = run_sweep("VAE", base, axes, skip_done=True, runner_kwargs=FRAME, **kw)
    assert r3[0]["runner_kwargs"] == FRAME and r3[0]["wall_s"] != r1[0]["wall_s"]

    # a point killed in use_pallas=True mode leaves its state file; the
    # "frame" resume names another file and runs the point from frame 0
    fresh = dict(kw, out_dir=tmp_path / "k", checkpoint_every=1)

    def killer(frame, m):
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        run_sweep("VAE", base, axes, progress=killer, runner_kwargs={"use_pallas": True}, **fresh)
    (stale,) = (tmp_path / "k").glob("state_t_*.npz")
    calls = _counting(monkeypatch)
    (rec,), _, _ = run_sweep("VAE", base, axes, skip_done=True, runner_kwargs=FRAME, **fresh)
    assert calls[0][2]["checkpoint"] != stale and stale.exists()
    (want,), _, _ = run_sweep("VAE", base, axes, runner_kwargs=FRAME,
                              **dict(fresh, out_dir=tmp_path / "w"))
    np.testing.assert_array_equal(rec["ser"], want["ser"])
