"""The sharded runners' ``compiled``, ``chunk_frames`` and ``checkpoint``
(``parallel/seqpar.py``) on the CPU, ranks joined by ``gloo``, at
``tests/test_torch_seqpar.py``'s tiny configurations on JAX's draws.

Four spawns of two ranks: dp 1 x sp 2 runs the loop, compiled and
``chunk_frames=2`` modes of the VAE and VAEflex runners and two
checkpointed runs that finish; a second dp 1 x sp 2 spawn is killed from
rank 0's ``progress`` after its first save; a third resumes that file; a
dp 2 x sp 1 spawn resumes a copy of it on the other split. Held: the graph
modes and the resumed run bit for bit to the loop, the file's carry with
every run, the other mesh's frames before the resume point, a mismatched
file refused before any rank starts, and the compiled mode against JAX's
``train_vae_dp_sharded(compiled=True)``.
"""

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from test_torch_seqpar import CFGS, _draws
from test_torch_train_dp import RUNS
from vae_equalizer_tpu.parallel.seqpar import make_mesh_2d as j_make_mesh_2d
from vae_equalizer_tpu.parallel.seqpar import train_vae_dp_sharded as j_train_vae_dp_sharded
from vae_equalizer_tpu.utils.config import DpConfig as JDpConfig
from vae_equalizer_tpu_torch.parallel.mesh import make_mesh_2d, run_ranks
from vae_equalizer_tpu_torch.parallel.seqpar import sharded_call
from vae_equalizer_tpu_torch.utils import DpConfig

torch.set_num_threads(1)

MODES = {"loop": {}, "compiled": {"compiled": True}, "chunked": {"chunk_frames": 2}}
KILL_AT = 0  # rank 0's progress raises in frame 0, after the save at frame 1 (K = 1)


class Kill(Exception):
    """A simulated kill (not a RuntimeError: ``run_ranks`` then stops the
    spawned ranks at once)."""


def _call(mesh, name, draws, **kw):
    return sharded_call(DpConfig(**CFGS[name][0]), 0, device="cpu", runs=RUNS, mesh=mesh,
                        flex_windows=name == "VAEflex", draws=lambda f, r: draws[name][f], **kw)[1]


def _killer(frame, m):
    if frame == KILL_AT:
        raise Kill()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seqpar_options")
    draws = {name: _draws(name) for name in CFGS}
    mesh = make_mesh_2d(1, 2, devices="cpu")
    stats = {}
    calls = [_call(mesh, name, draws, **kw) for name in CFGS for kw in MODES.values()] + [
        _call(mesh, "VAE", draws, checkpoint=tmp / "loop.npz", checkpoint_every=1, stats=stats),
        _call(mesh, "VAEflex", draws, chunk_frames=2, checkpoint=tmp / "chunked.npz",
              checkpoint_every=1)]
    out = iter(run_ranks(mesh, calls))
    res = {name: {mode: next(out) for mode in MODES} for name in CFGS}
    res["ck_loop"], res["ck_chunked"] = next(out), next(out)
    with pytest.raises(Kill):
        run_ranks(mesh, [_call(mesh, "VAE", draws, checkpoint=tmp / "killed.npz",
                               checkpoint_every=1, progress=_killer)])
    shutil.copy(tmp / "killed.npz", tmp / "other_mesh.npz")
    with np.load(tmp / "killed.npz") as d:
        killed_at = int(d["frame"])
    (res["resumed"],) = run_ranks(mesh, [_call(mesh, "VAE", draws, checkpoint=tmp / "killed.npz",
                                               checkpoint_every=1)])
    mesh21 = make_mesh_2d(2, 1, devices="cpu")
    (res["other_mesh"],) = run_ranks(mesh21, [_call(mesh21, "VAE", draws,
                                                    checkpoint=tmp / "other_mesh.npz",
                                                    checkpoint_every=1)])
    return dict(res, tmp=tmp, draws=draws, stats=stats, killed_at=killed_at)


def _assert_same(got, want):
    for k in ("ser", "mi", "var_est", "var"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("w", "h"):
        assert torch.equal(got["params"][k], want["params"][k]), k


@pytest.mark.parametrize("name", sorted(CFGS))
def test_compiled_and_chunked_equal_the_loop(runs, name):
    """compiled (one copy of the history at the end) and chunk_frames=2 (one
    per chunk, a short last chunk) give the sharded loop's results bit for
    bit; so does a checkpointed run that finishes."""
    for mode in ("compiled", "chunked"):
        _assert_same(runs[name][mode], runs[name]["loop"])
    _assert_same(runs["ck_loop" if name == "VAE" else "ck_chunked"], runs[name]["loop"])


def test_state_file_carries_every_run(runs):
    """The file holds the whole carry of all R runs (w, h and the four Adam
    moments with their (R, ...) axis, and the step count), the histories of
    all runs and the next frame: the loop saved after frames 1 and 2 of 3
    (K = 1), the chunked run at its first chunk's end (frame 2); the step
    count is 2 frames of minibatches (VAE 10, VAEflex 6 windows a frame)."""
    m = DpConfig(**CFGS["VAE"][0]).m_est
    for f, every_run, steps in (("loop.npz", runs["ck_loop"], 10),
                                ("chunked.npz", runs["ck_chunked"], 6)):
        with np.load(runs["tmp"] / f) as d:
            leaves = [d[f"leaf_{i:04d}"] for i in range(7)]
            assert int(d["frame"]) == 2 and str(d["ident"]) in ("VAE-SP", "VAEflex-SP")
            assert d["hist_ser_soft"].shape == (RUNS, 2, 3)
            np.testing.assert_array_equal(d["hist_ser_soft"][..., :2],
                                          every_run["ser"][:, 2:, :2])
            assert not d["hist_ser_soft"][..., 2].any()
        # (h, w), (mh, mw, vh, vw), count: every leaf but the count has the runs axis
        shapes = [(RUNS, 2, 2, 2, m), (RUNS, 2, 4, m)] * 3
        assert [x.shape for x in leaves[:6]] == shapes and leaves[6].shape == (1,)
        assert np.all(leaves[5] > 0) and not np.array_equal(leaves[1][0], leaves[1][1])
        assert leaves[6].tolist() == [2 * steps]


def test_killed_run_resumes_bit_for_bit(runs):
    """Killed in frame 0's progress after the save at frame 1, the resumed
    run (which saves again at frame 2) equals the uninterrupted loop bit for
    bit: histories, var and the final params of every run."""
    assert runs["killed_at"] == KILL_AT + 1
    _assert_same(runs["resumed"], runs["VAE"]["loop"])


def test_file_from_one_mesh_resumes_on_another(runs):
    """A dp 1 x sp 2 file resumed on dp 2 x sp 1 (each rank one run) runs to
    the end: the frames before the resume point equal bit for bit (they come
    from the file) and every value is finite."""
    got, want = runs["other_mesh"], runs["VAE"]["loop"]
    before = (..., slice(0, runs["killed_at"]))
    for k in ("ser", "mi", "var_est"):
        np.testing.assert_array_equal(got[k][before], want[k][before], err_msg=k)
        assert got[k].shape == want[k].shape and np.all(np.isfinite(got[k])), k
    assert all(torch.all(torch.isfinite(v)) for v in got["params"].values())


def test_mismatched_file_raises_before_any_rank(runs):
    """Another runner (VAEflex on a VAE file), other shapes (4 runs, another
    M) and other draws (the default generator on a file written with
    injected draws) raise ValueError in ``sharded_call``, before a rank
    starts; compiled mode ignores the file, as in JAX."""
    path, mesh = runs["tmp"] / "loop.npz", make_mesh_2d(1, 2, devices="cpu")
    base = DpConfig(**CFGS["VAE"][0])
    draws = lambda f, r: runs["draws"]["VAE"][f]  # noqa: E731
    cases = [(dict(flex_windows=True, draws=draws), "VAEflex-SP"),
             (dict(runs=4, draws=draws), "does not match"),
             (dict(cfg=dataclasses.replace(base, m_est=23), draws=draws), "does not match"),
             (dict(), "no draw-generator state")]
    for kw, match in cases:
        cfg = kw.pop("cfg", base)
        kw = {"runs": RUNS, **kw}
        with pytest.raises(ValueError, match=match):
            sharded_call(cfg, 0, device="cpu", mesh=mesh, checkpoint=path, checkpoint_every=1,
                         **kw)
    sharded_call(base, 0, device="cpu", runs=RUNS, mesh=mesh, compiled=True, checkpoint=path)
    with pytest.raises(ValueError, match="chunk_frames must be >= 1"):
        sharded_call(base, 0, device="cpu", runs=RUNS, mesh=mesh, chunk_frames=0)


def test_compiled_matches_jax_compiled_on_jax_draws(runs):
    """The port's compiled sharded VAE (dp 1 x sp 2, JAX's draws) against
    JAX's ``train_vae_dp_sharded(compiled=True)`` on its own 1 x 2 mesh, at
    ``test_sharded_runner_matches_jax_and_port_on_jax_draws``'s tolerances
    (frames 0-1: SER atol 2e-3, MI 1e-2, var_est rtol 1e-3)."""
    kw, key = CFGS["VAE"]
    a = j_train_vae_dp_sharded(JDpConfig(**kw), jax.random.PRNGKey(key), runs=RUNS,
                               mesh=j_make_mesh_2d(1, 2), compiled=True)
    b = runs["VAE"]["compiled"]
    assert b["ser"].shape == np.asarray(a["ser"]).shape == (RUNS, 4, 3)
    early = (..., slice(0, 2))
    np.testing.assert_allclose(b["ser"][early], np.asarray(a["ser"])[early], atol=2e-3)
    np.testing.assert_allclose(b["mi"][early], np.asarray(a["mi"])[early], atol=1e-2)
    np.testing.assert_allclose(b["var_est"][early], np.asarray(a["var_est"])[early], rtol=1e-3)
    assert np.all(np.isfinite(b["ser"])) and np.all(np.isfinite(b["mi"]))


def test_saves_are_timed_per_rank_zero(runs):
    """``stats["saves"]``: (frame, gather seconds, write seconds) of each of
    the checkpointed loop's saves, after frames 1 and 2."""
    saves = runs["stats"]["saves"]
    assert [f for f, _, _ in saves] == [1, 2]
    assert all(g >= 0 and w > 0 for _, g, w in saves)
