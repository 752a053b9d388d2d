"""The port's dp x sp sequence parallelism (``parallel/mesh.py``,
``parallel/seqpar.py``, ``parallel/dryrun.py``) on the CPU, ranks joined by
``gloo``, against the JAX package.

Three spawns of ranks: ``halo_exchange`` on a 1 x 4 mesh (forward and
backward against the zero-padded gathered array and its autograd
transpose); one dp 2 x sp 2 mesh that runs, in order, one sharded step on
``tests/test_seqpar.py``'s inputs (held, raw gradients before Adam
included, to JAX's single-device ``jax.value_and_grad``), then
``train_vae_dp_sharded`` and ``train_vae_flex_dp_sharded`` on JAX's draws
(held to JAX's ``train_vae_dp`` / ``train_vae_flex_dp`` at
``tests/test_seqpar.py``'s tolerances, and to the port's unsharded runner
on the same draws, tighter); and ``dryrun_multichip(2)``. Also JAX's
refusals, and the mesh's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_seqpar import _reference_step
from test_torch_train_dp import RUNS, _jax_draws
from vae_equalizer_tpu.core import make_constellation as j_make_constellation
from vae_equalizer_tpu.core.constellation import demapper_noise_var as j_demapper_noise_var
from vae_equalizer_tpu.models import vae_le_dp_forward as j_vae_le_dp_forward
from vae_equalizer_tpu.models.losses import elbo_dp as j_elbo_dp
from vae_equalizer_tpu.parallel.seqpar import make_mesh_2d as j_make_mesh_2d
from vae_equalizer_tpu.parallel.seqpar import train_vae_dp_sharded as j_train_vae_dp_sharded
from vae_equalizer_tpu.train import train_vae_dp as j_train_vae_dp
from vae_equalizer_tpu.train import train_vae_flex_dp as j_train_vae_flex_dp
from vae_equalizer_tpu.utils.config import DpConfig as JDpConfig
from vae_equalizer_tpu_torch.core import demapper_noise_var, make_constellation
from vae_equalizer_tpu_torch.models import elbo_dp, vae_le_dp_forward
from vae_equalizer_tpu_torch.parallel.dryrun import dryrun_multichip, halo_roundtrip
from vae_equalizer_tpu_torch.parallel.mesh import Call, make_mesh_2d, run_ranks
from vae_equalizer_tpu_torch.parallel.seqpar import (
    make_sp_dp_train_step,
    sharded_call,
    train_vae_dp_sharded,
    train_vae_flex_dp_sharded,
)
from vae_equalizer_tpu_torch.train import train_vae_dp, train_vae_flex_dp
from vae_equalizer_tpu_torch.train.dp import _setup
from vae_equalizer_tpu_torch.utils import DpConfig

torch.set_num_threads(1)

# tests/test_seqpar.py:41-65's step and :84-134's experiments
STEP = dict(mod="16-QAM", nu=0.0270955, snr_db=20.0, m_est=25, sps=2, lr=2.5e-3)
N_STEP = 512
CFGS = {
    "VAE": (dict(mod="4-QAM", snr_db=20.0, num_frames=3, n_frame_max=1000, lr=2.5e-3), 7),
    "VAEflex": (dict(mod="4-QAM", snr_db=20.0, num_frames=3, n_frame_max=400, batch_len=100,
                     flex_step=50, lr=2.5e-3), 9),
}


def _draws(name):
    kw, key = CFGS[name]
    cfg = DpConfig(**kw)
    sim = _setup(cfg, cfg.n_frame_max // cfg.batch_len * cfg.batch_len, "cpu")[2]
    return _jax_draws(cfg, jax.random.PRNGKey(key), sim)


@pytest.fixture(scope="module")
def sharded():
    """One dp 2 x sp 2 spawn: the step, then both runners on JAX's draws."""
    mesh = make_mesh_2d(2, 2, devices="cpu")
    step = make_sp_dp_train_step(mesh, **STEP)
    params, opt = step.init(RUNS)
    rx = np.random.default_rng(0).normal(size=(RUNS, 2, 2, N_STEP)).astype(np.float32) * 0.5
    draws = {name: _draws(name) for name in CFGS}
    calls = [step.call(params, opt, torch.from_numpy(rx))] + [
        sharded_call(DpConfig(**CFGS[name][0]), 0, runs=RUNS, mesh=mesh,
                     flex_windows=name == "VAEflex", draws=lambda f, r, d=draws[name]: d[f])[1]
        for name in CFGS]
    step_res, vae, flex = run_ranks(mesh, calls)
    return {"params": params, "opt": opt, "rx": rx, "step": step_res, "VAE": vae,
            "VAEflex": flex, "draws": draws}


def test_halo_exchange_matches_zero_padded_gather():
    """Four sp ranks: every block's halo'd extension equals its window of the
    zero-padded gathered array, and the backward (each halo's gradient sent
    back to its owner's edge columns) equals that window's autograd
    transpose, bit for bit; a one-sided halo too."""
    mesh = make_mesh_2d(1, 4, devices="cpu")
    rng = np.random.default_rng(3)
    ln, cases = 30, [(24, 12), (12, 0)]
    x = rng.normal(size=(2, 4, 4 * ln)).astype(np.float32)
    gs = [rng.normal(size=(4, 2, 4, lft + ln + rgt)).astype(np.float32) for lft, rgt in cases]
    got = run_ranks(mesh, [Call(halo_roundtrip, (x, g, lft, rgt))
                           for g, (lft, rgt) in zip(gs, cases)])
    for (out, grad), g, (lft, rgt) in zip(got, gs, cases):
        xt = torch.from_numpy(x).requires_grad_()
        xp = torch.nn.functional.pad(xt, (lft, rgt))
        ref = [xp[..., s * ln : s * ln + lft + ln + rgt] for s in range(4)]
        dot = sum((o * torch.from_numpy(g[s])).sum() for s, o in enumerate(ref))
        (gx,) = torch.autograd.grad(dot, xt)
        assert torch.equal(out, torch.stack([o.detach() for o in ref])), (lft, rgt)
        assert torch.equal(torch.cat(list(grad), -1), gx), (lft, rgt)


def test_a_spawned_ranks_failure_fails_the_caller():
    """A spawned rank's exception reaches the caller (rank 0's collective
    fails when its peer dies, and the peer's own error is raised): here rank
    1 finds no upstream gradient for its block."""
    x = np.zeros((1, 8), np.float32)
    g = np.zeros((1, 1, 1 + 4 + 1), np.float32)  # rank 0's only
    with pytest.raises(torch.multiprocessing.ProcessRaisedException, match="IndexError"):
        run_ranks(make_mesh_2d(1, 2, devices="cpu"), [Call(halo_roundtrip, (x, g, 1, 1))])


def test_sharded_step_matches_jax_value_and_grad(sharded):
    """dp 2 x sp 2, one step on tests/test_seqpar.py's inputs: the loss,
    var_est and the RAW gradients (before Adam, whose sign-like step would
    hide a gradient scaled by n_sp or short of the halo's block-boundary
    terms) against JAX's single-device value_and_grad of vae_le_dp_forward
    + elbo_dp and the port's unsharded autograd of the same: loss and
    var_est rtol 2e-5, gradients within 1e-5 of their largest entry; the
    params after one Adam step against JAX's sharded test's single-device
    reference (rtol 1e-4, atol 2e-6)."""
    res, rx = sharded["step"], sharded["rx"]
    const = j_make_constellation(STEP["mod"], STEP["nu"])
    amps, P = jnp.asarray(const.amps), jnp.asarray(const.P, jnp.float32)
    var = jnp.full((2,), j_demapper_noise_var(const, STEP["snr_db"]), jnp.float32)
    p0 = {k: jnp.asarray(v.numpy()) for k, v in sharded["params"].items()}

    def loss_fn(p, x):
        q, _ = j_vae_le_dp_forward(p["w"], x, amps, var, const.nu_sc, STEP["sps"])
        return j_elbo_dp(q, x, p["h"], amps, P)

    (loss, var_est), g = jax.vmap(jax.value_and_grad(loss_fn, has_aux=True))(p0, jnp.asarray(rx))
    # the port's unsharded autograd step on the same tensors
    pconst = make_constellation(STEP["mod"], STEP["nu"])
    p_amps = torch.from_numpy(pconst.amps)
    p_P = torch.from_numpy(np.asarray(pconst.P, np.float32))
    p_var = torch.full((2,), float(np.float32(demapper_noise_var(pconst, STEP["snr_db"]))))
    w, h = (sharded["params"][k].clone().requires_grad_() for k in ("w", "h"))
    q, _ = vae_le_dp_forward(w, torch.from_numpy(rx), p_amps, p_var, pconst.nu_sc, STEP["sps"])
    p_loss, p_var_est = elbo_dp(q, torch.from_numpy(rx), h, p_amps, p_P)
    p_g = dict(zip(("w", "h"), torch.autograd.grad(p_loss.sum(), (w, h))))
    for want_loss, want_var, want_g in ((np.asarray(loss), np.asarray(var_est), g),
                                        (p_loss.detach().numpy(), p_var_est.numpy(), p_g)):
        np.testing.assert_allclose(res["loss"].numpy(), want_loss, rtol=2e-5)
        np.testing.assert_allclose(res["var_est"].numpy(), want_var, rtol=2e-5)
        for k in ("w", "h"):
            want = np.asarray(want_g[k])
            np.testing.assert_allclose(res["grads"][k].numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(), err_msg=k)
    s0 = jax.vmap(optax.adam(STEP["lr"]).init)(p0)
    p1, _, _, _ = _reference_step(p0, s0, jnp.asarray(rx), const, var, STEP["sps"], STEP["lr"])
    for k in ("w", "h"):
        np.testing.assert_allclose(res["params"][k].numpy(), np.asarray(p1[k]), rtol=1e-4,
                                   atol=2e-6)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_sharded_runner_matches_jax_and_port_on_jax_draws(sharded, name):
    """train_vae_dp_sharded / train_vae_flex_dp_sharded (dp 2 x sp 2) on
    JAX's draws against JAX's unsharded runner at tests/test_seqpar.py's
    tolerances (frames 0-1: SER atol 2e-3, MI 1e-2, var_est rtol 1e-3; every
    frame finite), and against the port's unsharded runner (autograd, the
    same draws) tighter: the same decisions on frames 0-1, MI atol 1e-3,
    var_est rtol 1e-4."""
    kw, key = CFGS[name]
    b = sharded[name]
    j_run, p_run = ((j_train_vae_dp, train_vae_dp) if name == "VAE"
                    else (j_train_vae_flex_dp, train_vae_flex_dp))
    a = j_run(JDpConfig(**kw), jax.random.PRNGKey(key), runs=RUNS)
    c = p_run(DpConfig(**kw), 0, device="cpu", runs=RUNS,
              draws=lambda f, r: sharded["draws"][name][f])
    assert b["ser"].shape == np.asarray(a["ser"]).shape == (RUNS, 4, 3)
    early = (..., slice(0, 2))
    np.testing.assert_allclose(b["ser"][early], np.asarray(a["ser"])[early], atol=2e-3)
    np.testing.assert_allclose(b["mi"][early], np.asarray(a["mi"])[early], atol=1e-2)
    np.testing.assert_allclose(b["var_est"][early], np.asarray(a["var_est"])[early], rtol=1e-3)
    np.testing.assert_allclose(b["ser"][early], c["ser"][early], rtol=0, atol=1e-6)
    np.testing.assert_allclose(b["mi"][early], c["mi"][early], atol=1e-3)
    np.testing.assert_allclose(b["var_est"][early], c["var_est"][early], rtol=1e-4)
    np.testing.assert_array_equal(b["var"], c["var"])
    assert np.all(np.isfinite(b["ser"])) and np.all(b["ser"] <= 1.0)
    assert np.all(np.isfinite(b["mi"]))
    for k in ("w", "h"):
        assert b["params"][k].shape == c["params"][k].shape
        assert torch.all(torch.isfinite(b["params"][k]))


def test_dryrun_multichip_on_cpu_ranks():
    """The dryrun's self-certification (two gloo ranks on the CPU, 64-QAM):
    the sharded SER within 6 / n_frame_max of the single-device runner."""
    res = dryrun_multichip(2, device="cpu")
    assert (res["n_dp"], res["n_sp"]) == (1, 2) and res["d_ser"] <= res["tol"]
    assert res["ser"].shape == (1, 4, 2)


def test_refusals_equal_jaxs_and_mesh_rules():
    """JAX's ValueErrors, message for message (runs not a multiple of dp, a
    minibatch that does not split over sp in whole symbols, even M_est,
    VAEflex batch_len not a multiple of flex_step), all before a rank
    starts; the mesh's refusals: nccl for two ranks on
    one card or on the CPU, more ranks than cards, a wrong device count."""
    mesh, j_mesh = make_mesh_2d(2, 2, devices="cpu"), j_make_mesh_2d(2, 2)
    base = dict(mod="4-QAM", num_frames=1, n_frame_max=400)
    cases = [(dict(base), 3, False), (dict(base, batch_len=50), 2, False),
             (dict(base, m_est=24), 2, False),
             (dict(base, batch_len=100, flex_step=30), 2, True)]
    for kw, runs, flex in cases:
        mesh_k, j_mesh_k = ((make_mesh_2d(1, 4, devices="cpu"), j_make_mesh_2d(1, 4))
                            if kw.get("batch_len") == 50 else (mesh, j_mesh))
        with pytest.raises(ValueError) as e:
            (train_vae_flex_dp_sharded if flex else train_vae_dp_sharded)(
                DpConfig(**kw), 0, runs=runs, mesh=mesh_k)
        with pytest.raises(ValueError) as j_e:
            j_train_vae_dp_sharded(JDpConfig(**kw), jax.random.PRNGKey(0), runs=runs, mesh=j_mesh_k,
                                   flex_windows=flex)
        assert str(e.value) == str(j_e.value)
    for devices in (["cuda:0"] * 2, "cpu"):
        with pytest.raises(ValueError, match="nccl needs one distinct card per rank"):
            make_mesh_2d(1, 2, devices=devices, backend="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs 2 cards, 0 present"):
            make_mesh_2d(1, 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_vae_dp_sharded(DpConfig(**base), 0)
    with pytest.raises(ValueError, match="needs 4 devices, got 2"):
        make_mesh_2d(2, 2, devices=["cpu", "cpu"])
    assert make_mesh_2d(2, 2, devices="cpu").backend == "gloo"
