"""Run sharding (``train/batching.py``, ``parallel/mesh.py: run_mesh``) on the
CPU, ranks joined by ``gloo``:

(a) the split rule against JAX's ``shard_runs`` placement on the 8 virtual
    CPU devices (``tests/conftest.py``), with the unit of an explicit
    ``runs_batch``;
(b) each of the six runners under a mesh of two ranks against its call with
    ``mesh=None``, bit for bit: ``compiled``, ``chunk_frames``,
    ``runs_batch``, the sweep vectors, the caller's ``draws`` and
    ``progress`` included;
(c) the flagship under the mesh on JAX's draws against JAX's
    ``train_vae_dp(runs=4, mesh=run_mesh(2))``;
(d) checkpoint files: written under the mesh, the unsharded call's file
    (every array equal) and resumed with ``mesh=None`` to the uninterrupted
    run's bits; an unsharded file resumed under the mesh likewise;
(e) ``run_sweep`` under the mesh against it without; a driver with and
    without ``--no-mesh``.

One spawn of two ranks runs (b), (c) and (d)'s sharded calls; the sweep's
two grid points are one spawn each.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch
from jax.sharding import Mesh as JMesh

from vae_equalizer_tpu.core.constellation import sample_levels as j_sample_levels
from vae_equalizer_tpu.parallel import run_mesh as j_run_mesh
from vae_equalizer_tpu.train.batching import shard_runs
from vae_equalizer_tpu.train.dp import train_vae_dp as j_train_vae_dp
from vae_equalizer_tpu.utils.config import DpConfig as JDpConfig
from vae_equalizer_tpu_torch.core import make_constellation
from vae_equalizer_tpu_torch.drivers import eval_run_shaping_vaele
from vae_equalizer_tpu_torch.parallel import make_mesh_2d, run_mesh, run_sweep
from vae_equalizer_tpu_torch.parallel.mesh import run_ranks
from vae_equalizer_tpu_torch.train import (
    run_cma_awgn,
    run_cma_dp,
    train_vae_dp,
    train_vae_flex_dp,
    train_vae_le_awgn,
    train_vae_nn_awgn,
)
from vae_equalizer_tpu_torch.train.batching import runs_call, split_runs
from vae_equalizer_tpu_torch.train.dp import _setup
from vae_equalizer_tpu_torch.utils import AwgnCmaConfig, AwgnVaeLeConfig, AwgnVaeNnConfig, DpConfig

torch.set_num_threads(1)


def assert_same(got, want, path: str = "result") -> None:
    """Two runner results (nested dicts of arrays, tensors and numbers) bit for bit."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.device == want.device, path
        assert torch.equal(got, want), (path, float((got - want).abs().max()))
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


def check_mesh_argument(run) -> None:
    """``run(mesh=...)``, a runner call with ``runs`` set: a non-``Mesh``
    object and a mesh with an sp axis raise ``ValueError``, and the one-rank
    ``run_mesh(device="cpu")`` gives the call with ``mesh=None`` bit for bit."""
    for bad in (object(), make_mesh_2d(1, 2, devices="cpu")):
        with pytest.raises(ValueError, match="mesh"):
            run(mesh=bad)
    assert_same(run(mesh=run_mesh(device="cpu")), run(mesh=None))


# ---- (a) the split rule


@pytest.mark.parametrize("runs,n,rb", [(6, 2, None), (6, 4, None), (8, 2, None), (8, 4, None),
                                       (15, 2, None), (15, 4, None), (8, 4, 2), (6, 4, 2),
                                       (12, 4, 3)])
def test_split_matches_jax_placement(runs, n, rb):
    """Each device's runs under JAX's ``shard_runs`` (the largest divisor
    submesh where the unit count does not divide the mesh; with
    ``runs_batch`` the ``(groups, runs_batch)`` carry's groups) are the
    port's ranks' runs, device i as rank i."""
    units = runs // (rb or 1)
    x = shard_runs(jnp.zeros((units,) + ((rb,) if rb else ())), JMesh(np.asarray(jax.devices()[:n]),
                                                                     ("runs",)))
    placed = x.sharding.devices_indices_map(x.shape)
    want = []
    for d in jax.devices()[:n]:
        if d in placed:
            sl = placed[d][0]
            lo, hi = sl.start or 0, units if sl.stop is None else sl.stop
            want.append(range(lo * (rb or 1), hi * (rb or 1)))
    assert split_runs(runs, n, rb) == want


def test_split_refuses_a_batch_that_does_not_divide():
    with pytest.raises(ValueError, match="runs_batch=4 must divide runs=6"):
        split_runs(6, 2, 4)


# ---- (b)-(d): one spawn of two ranks

DP = dict(mod="4-QAM", num_frames=3, n_frame_max=200, batch_len=50, n_lrhalf=1)
CMA_DP = dict(mod="4-QAM", snr_db=20.0, num_frames=3, n_frame_max=600, batch_len=100, flex_step=10,
              m_est=5, n_lrhalf=170, lr=1e-4)
LE = dict(mod="16-QAM", snr_db=20.0, lr=2e-3, num_epochs=4, epe=2, n_train=384, batch_len=128,
          n_valid=1000)
NN = dict(mod="4-QAM", snr_db=10.0, lr=4e-3, num_epochs=4, epe=2, n_train=200, batch_len=100,
          n_valid=1000, m_est=9, kernel_1=7)
CMA = dict(mod="4-QAM", snr_db=12.0, lr=1e-3, num_epochs=6, epe=2, n_train=1000, n_valid=2000)
VEC = dict(lr_vec=[1e-3, 2e-3, 3e-3, 4e-3], snr_vec=[18.0, 19.0, 20.0, 21.0],
           nu_vec=[0.0, 0.01, 0.02, 0.03])

# name: (runner, config, keyword arguments); "progress" cases record it
CASES = {
    "vae_frame_vec_progress": (train_vae_dp, DpConfig(**DP),
                               dict(runs=4, use_pallas="frame", runs_batch=2, **VEC)),
    "vae_frame_compiled": (train_vae_dp, DpConfig(**DP), dict(runs=4, use_pallas="frame",
                                                              compiled=True)),
    "vae_true": (train_vae_dp, DpConfig(**DP), dict(runs=2, use_pallas=True)),
    "flex_frame_chunked": (train_vae_flex_dp, DpConfig(**{**DP, "flex_step": 10}),
                           dict(runs=2, use_pallas="frame", chunk_frames=2)),
    "cma_kernel": (run_cma_dp, DpConfig(loss_type="CMA", **CMA_DP), dict(runs=4, use_pallas=True)),
    "cmaflex_frame_compiled": (run_cma_dp, DpConfig(loss_type="CMAflex", **CMA_DP),
                               dict(runs=4, use_pallas="frame", runs_batch=2, compiled=True)),
    "vaele_frame_batched": (train_vae_le_awgn, AwgnVaeLeConfig(**LE),
                            dict(runs=4, use_pallas="frame", runs_batch=2)),
    "vaele_kernel_compiled": (train_vae_le_awgn, AwgnVaeLeConfig(**LE),
                              dict(runs=4, use_pallas=True, compiled=True)),
    "vaele_loop_progress": (train_vae_le_awgn, AwgnVaeLeConfig(**LE), dict(runs=2)),
    "vaenn_loop": (train_vae_nn_awgn, AwgnVaeNnConfig(**NN), dict(runs=2)),
    "vaenn_bn_compiled": (train_vae_nn_awgn, AwgnVaeNnConfig(**NN, batchnorm=True),
                          dict(runs=2, compiled=True)),
    "vaenn_frame": (train_vae_nn_awgn, AwgnVaeNnConfig(**NN), dict(runs=2, use_pallas="frame")),
    "cma_awgn_progress": (run_cma_awgn, AwgnCmaConfig(**CMA), dict(runs=4)),
}
# (d): runner calls with a checkpoint every K frames / epochs; a finished run
# leaves its file at the last save, short of the end
CHECKPOINTED = {
    "vae_frame": (train_vae_dp, DpConfig(**DP), dict(runs=4, use_pallas="frame"), 1),
    "vae_chunked": (train_vae_dp, DpConfig(**DP), dict(runs=4, use_pallas="frame",
                                                       chunk_frames=2), 1),
    "cma": (run_cma_dp, DpConfig(loss_type="CMAbatch", **CMA_DP), dict(runs=4), 1),
    "vaele_kernel": (train_vae_le_awgn, AwgnVaeLeConfig(**LE), dict(runs=4, use_pallas=True), 1),
    "cma_awgn": (run_cma_awgn, AwgnCmaConfig(**CMA), dict(runs=4), 2),
}
FLAGSHIP = dict(mod="4-QAM", num_frames=2, n_frame_max=200, batch_len=50, n_lrhalf=1)
SEED = 3


def _jax_draws(cfg, key, sim, runs):
    """JAX's per-frame, per-run draws (``tests/test_torch_train_dp.py:
    _jax_draws`` for ``runs`` runs)."""
    const = make_constellation(cfg.mod, cfg.nu)
    amps, P = jnp.asarray(const.amps), jnp.asarray(const.P, jnp.float32)
    out = []
    for fkey in jax.random.split(key, cfg.num_frames):
        lev, noi = [], []
        for rkey in jax.random.split(fkey, runs):
            k_sym, k_noise = jax.random.split(rkey)
            lev.append(np.array(j_sample_levels(k_sym, amps, P, (4, sim.n_conv))))
            noi.append(np.array(jax.random.normal(k_noise, (2, 2, sim.sig_len), jnp.float32)))
        out.append((torch.from_numpy(np.stack(lev)), torch.from_numpy(np.stack(noi))))
    return out


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("run_sharding")
    mesh = make_mesh_2d(2, 1, devices="cpu")
    progress = {}

    def recorder(key):
        progress[key] = []
        return lambda step, m: progress[key].append((step, m))

    ref, calls = {}, []
    for name, (fn, cfg, kw) in CASES.items():
        ref[name] = fn(cfg, SEED, device="cpu", **kw,
                       **({"progress": recorder(("ref", name))} if "progress" in name else {}))
        calls.append(runs_call(fn, cfg, SEED, device="cpu", mesh=mesh, **kw,
                               **({"progress": recorder(("mesh", name))} if "progress" in name
                                  else {})))

    # (c) the flagship's loop mode on JAX's draws, and JAX's own sharded run
    key = jax.random.PRNGKey(5)
    cfg = DpConfig(**FLAGSHIP)
    sim = _setup(cfg, cfg.n_frame_max // cfg.batch_len * cfg.batch_len, "cpu")[2]
    jd = _jax_draws(cfg, key, sim, 4)
    draws = lambda frame, r: jd[frame]  # noqa: E731
    ref["jax_draws"] = train_vae_dp(cfg, 0, device="cpu", runs=4, draws=draws)
    calls.append(runs_call(train_vae_dp, cfg, 0, device="cpu", runs=4, mesh=mesh, draws=draws))
    jax_res = j_train_vae_dp(JDpConfig(**FLAGSHIP), key, runs=4, mesh=j_run_mesh(2))

    # (d) the uninterrupted runs; files written without the mesh (resumed under
    # it in the spawn) and under it (resumed without it after)
    full, resumed = {}, {}
    for name, (fn, cfg, kw, every) in CHECKPOINTED.items():
        full[name] = fn(cfg, SEED, device="cpu", **kw)
        fn(cfg, SEED, device="cpu", checkpoint=tmp / f"{name}_plain.npz", checkpoint_every=every,
           **kw)
        shutil.copy(tmp / f"{name}_plain.npz", tmp / f"{name}_plain_written.npz")
        calls.append(runs_call(fn, cfg, SEED, device="cpu", mesh=mesh, **kw,
                               checkpoint=tmp / f"{name}_mesh.npz", checkpoint_every=every))
        calls.append(runs_call(fn, cfg, SEED, device="cpu", mesh=mesh, **kw,
                               checkpoint=tmp / f"{name}_plain.npz", checkpoint_every=every))
    assert all(ranks == mesh for ranks, _ in calls)
    out = iter(run_ranks(mesh, [c for _, c in calls]))
    got = {name: next(out) for name in CASES}
    got["jax_draws"] = next(out)
    for name, (fn, cfg, kw, every) in CHECKPOINTED.items():
        got[f"ck_{name}"], resumed[f"{name}_on_mesh"] = next(out), next(out)
        shutil.copy(tmp / f"{name}_mesh.npz", tmp / f"{name}_mesh_written.npz")
        resumed[f"{name}_off_mesh"] = fn(cfg, SEED, device="cpu", **kw, checkpoint_every=every,
                                         checkpoint=tmp / f"{name}_mesh.npz")
    return dict(ref=ref, got=got, progress=progress, jax=jax_res, full=full, resumed=resumed,
                tmp=tmp)


@pytest.mark.parametrize("name", list(CASES))
def test_runner_under_mesh_equals_unsharded(sharded, name):
    """(b) Every run's histories and final parameters bit for bit; the
    recorded ``progress`` calls too (rank 0 sees every run's metrics)."""
    assert_same(sharded["got"][name], sharded["ref"][name])
    if "progress" in name:
        want, got = sharded["progress"][("ref", name)], sharded["progress"][("mesh", name)]
        assert [s for s, _ in got] == [s for s, _ in want] and want
        for (_, m_got), (_, m_want) in zip(got, want):
            assert_same(m_got, m_want)


def test_caller_draws_under_mesh_and_jax_sharded_runner(sharded):
    """(c) The caller's draws go from rank 0 to each rank's rows (bit for bit
    with the unsharded call), and the flagship under the mesh matches JAX's
    runner sharded over two devices at the autograd mode's tolerances
    (``tests/test_torch_train_vae_step.py``)."""
    got, res_j = sharded["got"]["jax_draws"], sharded["jax"]
    assert_same(got, sharded["ref"]["jax_draws"])
    assert got["ser"].shape == np.shape(res_j["ser"]) == (4, 4, FLAGSHIP["num_frames"])
    np.testing.assert_allclose(got["ser"], res_j["ser"], atol=0.01)
    np.testing.assert_allclose(got["mi"], res_j["mi"], rtol=2e-3)
    np.testing.assert_allclose(got["var_est"], res_j["var_est"], rtol=1e-3)
    np.testing.assert_allclose(got["params"]["w"].numpy(), np.asarray(res_j["params"]["w"]),
                               atol=1e-3)


@pytest.mark.parametrize("name", list(CHECKPOINTED))
def test_checkpoint_files_cross_the_mesh(sharded, name):
    """(d) The file written under the mesh holds what the unsharded run's
    holds, array for array; it resumes without the mesh, and the unsharded
    file under it, each to the uninterrupted run's bits; the checkpointed
    run under the mesh is itself the uninterrupted run."""
    tmp = sharded["tmp"]
    with np.load(tmp / f"{name}_mesh_written.npz") as a, np.load(
            tmp / f"{name}_plain_written.npz") as b:
        assert set(a.files) == set(b.files) and int(a["frame"]) > 0
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    full = sharded["full"][name]
    assert_same(sharded["got"][f"ck_{name}"], full)
    assert_same(sharded["resumed"][f"{name}_off_mesh"], full)
    assert_same(sharded["resumed"][f"{name}_on_mesh"], full)


# ---- (e) the sweep and a driver


def test_sweep_under_run_mesh(tmp_path):
    """``run_sweep`` with a runs mesh passes it to the runner of every grid
    point (``tests/test_sweep.py``'s sharded sweep): each record as without."""
    cfg = AwgnVaeLeConfig(**{**LE, "num_epochs": 2})
    kw = dict(iters=4, seed=1, device="cpu")
    with_mesh, axes, _ = run_sweep("VAE-LE-AWGN", cfg, {"lr": [3e-3, 5e-3]}, out_dir=tmp_path / "m",
                                   mesh=make_mesh_2d(2, 1, devices="cpu"), **kw)
    without, _, _ = run_sweep("VAE-LE-AWGN", cfg, {"lr": [3e-3, 5e-3]}, out_dir=tmp_path / "n",
                              **kw)
    assert len(with_mesh) == len(without) == 2 and list(axes) == ["lr"]
    for a, b in zip(with_mesh, without):
        assert a["coords"] == b["coords"]
        for k in ("ser", "mi"):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        assert np.asarray(a["ser"]).shape == (4, 1)


def test_driver_with_and_without_no_mesh(tmp_path):
    """The default runs mesh (one CPU rank for ``--device cpu``) and
    ``--no-mesh`` write the same .mat arrays."""
    mats = []
    for flag in ([], ["--no-mesh"]):
        name = eval_run_shaping_vaele.main(["--quick", "--device", "cpu", "--pallas-frame", *flag,
                                            "--out", str(tmp_path / (flag or ["mesh"])[0])])
        d = scipy.io.loadmat(name)["dict"]
        mats.append({k: d[k][0, 0] for k in d.dtype.names})
    assert list(mats[0]) == list(mats[1]) and "SER" in mats[0]
    for k in mats[0]:
        np.testing.assert_array_equal(mats[0][k], mats[1][k], err_msg=k)


def test_meshes_that_the_runners_refuse():
    """The runs mesh's own refusals: more cards than present; the runners'
    ``runs_call`` runs in this process where nothing splits."""
    with pytest.raises(RuntimeError, match="cards"):
        run_mesh(2)
    assert run_mesh(device="cpu").size == 1
    cfg = DpConfig(**DP)
    mesh = make_mesh_2d(2, 1, devices="cpu")
    assert runs_call(train_vae_dp, cfg, 0, device="cpu", runs=3, mesh=mesh) == (None, None)
    assert runs_call(train_vae_dp, cfg, 0, device="cpu", mesh=mesh) == (None, None)
    assert runs_call(train_vae_dp, cfg, 0, device="cpu", runs=4, runs_batch=4,
                     mesh=mesh) == (None, None)
    with pytest.raises(ValueError, match="runs_batch=3 must divide runs=4"):
        runs_call(train_vae_dp, cfg, 0, device="cpu", runs=4, runs_batch=3, mesh=mesh)
    ranks, _ = runs_call(train_vae_dp, cfg, 0, device="cpu", runs=6, mesh=make_mesh_2d(
        4, 1, devices="cpu"))
    assert dataclasses.astuple(ranks)[:2] == (2, 1)
