"""Port parity for the DP VAE's per-step modes: ``train_vae_dp(use_pallas=
False | True)``, kernel A with its runs axis, and the q-stream eval.

``True`` runs kernel A once per minibatch for all runs (its plain version on
the CPU); ``False`` takes the gradient by autograd through the model and the
ELBO. Both are held against the JAX package's per-step path
(``use_pallas=False``, ``jax.value_and_grad``) fed the very channel draws the
JAX simulator makes, through the ``draws`` seam (as in
tests/test_torch_train_dp.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_eval import N_MB, BL as EVAL_BL, R as EVAL_R, _frame
from test_torch_train_dp import RUNS, SMALL, _jax_draws
from vae_equalizer_tpu.ops.elbo_kernel import vae_dp_loss_and_grad_pallas
from vae_equalizer_tpu.ops.elbo_vjp import vae_dp_loss_bwd, vae_dp_loss_fwd
from vae_equalizer_tpu.train.dp import _dp_frame_eval_mb as j_dp_frame_eval_mb
from vae_equalizer_tpu.train.dp import _vae_optimizer
from vae_equalizer_tpu.train.dp import train_vae_dp as j_train_vae_dp
from vae_equalizer_tpu.train.eval_utils import batch_cut_weight as j_batch_cut
from vae_equalizer_tpu.utils.config import DpConfig as JDpConfig
from vae_equalizer_tpu_torch.core import demapper_noise_var, make_constellation
from vae_equalizer_tpu_torch.models import butterfly_init, dirac_taps_dp
from vae_equalizer_tpu_torch.ops.elbo_kernel import (
    VaeDpLoss,
    dp_step_plain,
    vae_dp_loss_and_grad,
    vae_dp_loss_and_grad_plain,
)
from vae_equalizer_tpu_torch.ops.frame_kernel import adam_update
from vae_equalizer_tpu_torch.train.dp import _dp_frame_eval, _setup, train_vae_dp
from vae_equalizer_tpu_torch.train.eval_utils import BatchCutWeight
from vae_equalizer_tpu_torch.utils import DpConfig
from vae_equalizer_tpu_torch.utils.convert import opt_from_jax

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

M, BL, R = 25, 50, 3
FIELDS = ("loss", "var_est", "gw", "gh", "q", "out")


def _inputs(mod, seed=7):
    """R runs' w, h and one window of a longer frame row, made with numpy."""
    const = make_constellation(mod, 0.0)
    rng = np.random.default_rng(seed)
    w = (butterfly_init(M).numpy() + 0.01 * rng.normal(size=(R, 2, 4, M))).astype(np.float32)
    h = (dirac_taps_dp(M).numpy() + 0.01 * rng.normal(size=(R, 2, 2, 2, M))).astype(np.float32)
    rx = (0.5 * rng.normal(size=(R, 2, 2, 6 * BL))).astype(np.float32)
    var = np.full(2, demapper_noise_var(const, 23.0), np.float32)
    return const, w, h, rx, var


def _rel_max(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _runs_batched(mod, seed=7):
    """The port's runs-batched step (CPU: the plain version) on a window of the
    frame rows read in place, as numpy, after checking it equals R single calls."""
    const, w, h, rx, var = _inputs(mod, seed)
    T = torch.from_numpy
    amps, P, v = T(const.amps), T(np.asarray(const.P, np.float32)), T(var)
    x = T(rx)[..., 2 * BL : 4 * BL]  # a window of the frame rows, not contiguous
    assert not x.is_contiguous()
    before = vae_dp_loss_and_grad.launches
    got = vae_dp_loss_and_grad(T(w), T(h), x, amps, v, const.nu_sc, P)
    assert vae_dp_loss_and_grad.launches == before  # CPU tensors: the plain version
    assert got[0].shape == (R,) and got[1].shape == (R, 2)
    assert got[4].shape == (R, 2, 2 * const.num_lev, BL) and got[5].shape == (R, 2, 2, BL)
    for r in range(R):
        one = vae_dp_loss_and_grad_plain(T(w[r]), T(h[r]), x[r].contiguous(), amps, v, const.nu_sc, P)
        for name, a, b in zip(FIELDS, got, one):
            # the same arithmetic with and without the batch axis
            np.testing.assert_allclose(a[r].numpy(), b.numpy(), rtol=1e-6, atol=1e-7, err_msg=name)
    jargs = (jnp.asarray(w), jnp.asarray(h), jnp.asarray(rx[..., 2 * BL : 4 * BL]),
             jnp.asarray(const.amps), jnp.asarray(var), const.nu_sc, jnp.asarray(const.P, jnp.float32))
    return dict(zip(FIELDS, (a.numpy() for a in got))), jargs


def _check_against(got, want):
    """The tolerances of tests/test_torch_elbo_kernel.py: f32 sums in another
    order, the softmin gain 1/(2 var) on q, gradients relative to their scale."""
    want = dict(zip(FIELDS, (np.asarray(a) for a in want)))
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-5)
    np.testing.assert_allclose(got["var_est"], want["var_est"], rtol=2e-5)
    np.testing.assert_allclose(got["out"], want["out"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["q"], want["q"], rtol=5e-4, atol=5e-5)
    for k in ("gw", "gh"):
        for r in range(R):
            assert _rel_max(got[k][r], want[k][r]) < 1e-4, k


@pytest.mark.parametrize("mod", ["4-QAM", "64-QAM"])
def test_kernel_a_runs_axis_matches_single_runs_and_jax(mod):
    """(a) The runs-batched plain step equals R single calls, and matches the
    JAX closed form (ops/elbo_vjp.py, the math of the TPU kernel) vmapped
    over runs."""
    got, jargs = _runs_batched(mod)

    def closed_form(*args):
        (loss, var_est), res = vae_dp_loss_fwd(*args)
        gw, gh = vae_dp_loss_bwd(*args, res)
        return loss, var_est, gw, gh, res[0], res[1]

    _check_against(got, jax.vmap(closed_form, in_axes=(0, 0, 0, None, None, None, None))(*jargs))


def test_kernel_a_runs_axis_matches_jax_kernel():
    """(a) The runs-batched plain step against the TPU kernel itself,
    ``vae_dp_loss_and_grad_pallas`` in interpret mode, vmapped over runs
    (one modulation: its interpret-mode compile takes ~1 min on the CPU)."""
    got, jargs = _runs_batched("64-QAM", seed=8)
    kernel = jax.vmap(functools.partial(vae_dp_loss_and_grad_pallas, interpret=True),
                      in_axes=(0, 0, 0, None, None, None, None))
    _check_against(got, kernel(*jargs))


def test_kernel_a_autograd_node_with_runs_axis():
    """VaeDpLoss with a runs axis: per-run loss, each run's gradient scaled
    by its own incoming gradient."""
    const, w, h, rx, var = _inputs("64-QAM", seed=2)
    T = torch.from_numpy
    args = (T(rx[..., : 2 * BL].copy()), T(const.amps), T(var), const.nu_sc,
            T(np.asarray(const.P, np.float32)))
    wt, ht = T(w).requires_grad_(), T(h).requires_grad_()
    loss, var_est = VaeDpLoss.apply(wt, ht, *args)
    assert loss.shape == (R,) and var_est.shape == (R, 2)
    scale = torch.tensor([1.0, -2.0, 0.5])
    (scale * loss).sum().backward()
    want = vae_dp_loss_and_grad_plain(T(w), T(h), *args)
    np.testing.assert_allclose(wt.grad.numpy(), (scale[:, None, None, None] * want[2]).numpy(), rtol=1e-6)
    np.testing.assert_allclose(ht.grad.numpy(), (scale[:, None, None, None, None] * want[3]).numpy(),
                               rtol=1e-6)


def test_adam_update_matches_optax_from_a_carried_state():
    """The one Adam helper against JAX's per-step optimizer
    (``_vae_optimizer``: optax multi_transform, w's lr halving at the
    threshold): start from JAX's state after 3 updates, carried over with
    ``opt_from_jax``, and take 3 more across the halving."""
    rng = np.random.default_rng(4)
    lr, thresh = 2.5e-3, 4.0
    opt = _vae_optimizer(JDpConfig(lr=lr, n_lrhalf=1), 4)  # threshold: step 4
    p = {"w": rng.normal(size=(R, 2, 4, M)).astype(np.float32),
         "h": rng.normal(size=(R, 2, 2, 2, M)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()} for _ in range(6)]
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    state = jax.vmap(opt.init)(pj)
    update = jax.vmap(opt.update)
    for g in grads[:3]:
        upd, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, pj)
        pj = optax.apply_updates(pj, upd)
    moments, count = opt_from_jax(state)
    assert count == 3 and set(moments) == {"mw", "vw", "mh", "vh"}
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    for i, g in enumerate(grads[3:]):
        upd, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, pj)
        pj = optax.apply_updates(pj, upd)
        pt, moments = adam_update(pt, moments, {k: torch.from_numpy(v) for k, v in g.items()}, lr,
                                  count + i, thresh)
    for k in ("w", "h"):
        # one float32 rounding per op in another order (optax folds the bias
        # correction into the moments); updates are ~lr
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    carried, _ = opt_from_jax(state)
    for k in ("mw", "vw", "mh", "vh"):
        np.testing.assert_allclose(moments[k].numpy(), carried[k].numpy(), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("mod", ["4-QAM", "64-QAM"])
def test_train_vae_dp_step_modes_match_jax_on_jax_draws(mod):
    """(c) use_pallas=False and True on the CPU against JAX's per-step path
    (use_pallas=False), frame for frame, on the JAX simulator's draws."""
    key = jax.random.PRNGKey(5)
    res_j = j_train_vae_dp(JDpConfig(mod=mod, **SMALL), key, runs=RUNS, use_pallas=False)
    cfg = DpConfig(mod=mod, **SMALL)
    sim = _setup(cfg, cfg.n_frame_max // cfg.batch_len * cfg.batch_len, "cpu")[2]
    draws = _jax_draws(cfg, key, sim)
    # autograd through the same formulas (measured: w within 1e-4, SER
    # equal); kernel A's closed form rounds otherwise, and Adam amplifies
    # that ~30x per step on this aggressive-lr toy (tests/test_frame_kernel.py)
    tol = {False: dict(ser=0.01, mi=2e-3, var_est=1e-3, w=1e-3),
           True: dict(ser=0.05, mi=5e-2, var_est=5e-2, w=0.05)}
    for mode, t in tol.items():
        res = train_vae_dp(cfg, 0, device="cpu", runs=RUNS, use_pallas=mode,
                           draws=lambda frame, r: draws[frame])
        assert res["ser"].shape == res_j["ser"].shape == (RUNS, 4, cfg.num_frames)
        assert res["var_est"].shape == res_j["var_est"].shape == (RUNS, 2, cfg.num_frames)
        assert np.all(np.isfinite(res["ser"])) and np.all(np.isfinite(res["mi"]))
        np.testing.assert_allclose(res["ser"], res_j["ser"], atol=t["ser"], err_msg=str(mode))
        np.testing.assert_allclose(res["mi"], res_j["mi"], rtol=t["mi"], err_msg=str(mode))
        np.testing.assert_allclose(res["var_est"], res_j["var_est"], rtol=t["var_est"], err_msg=str(mode))
        np.testing.assert_allclose(res["params"]["w"].numpy(), np.asarray(res_j["params"]["w"]),
                                   atol=t["w"], err_msg=str(mode))


def test_train_vae_dp_step_mode_single_run():
    """runs=None: one run without the runs axis, kernel mode on the CPU (the
    plain step, no launch)."""
    cfg = DpConfig(mod="4-QAM", **SMALL)
    before = vae_dp_loss_and_grad.launches
    res = train_vae_dp(cfg, 1, device="cpu", use_pallas=True)
    assert vae_dp_loss_and_grad.launches == before
    assert res["ser"].shape == (4, cfg.num_frames) and res["params"]["w"].shape == (2, 4, M)
    assert np.all(np.isfinite(res["mi"]))


def test_q_stream_eval_matches_jax_mb_branch():
    """(e) The per-step modes' eval (q packed time-major through
    ``_dp_frame_eval``) against the q branch of JAX's ``_dp_frame_eval_mb``
    on the same posteriors in minibatch layout, per run."""
    f = _frame(9)
    c = f["const"]
    T = torch.from_numpy
    amps, P, var = T(c.amps), T(np.asarray(c.P, np.float32)), T(f["var"])
    n_cut = 3
    got = _dp_frame_eval(T(f["q"]), T(f["out"]), T(f["tx"]), amps, P, c.nu_sc, var,
                         BatchCutWeight(N_MB, EVAL_BL, n_cut))
    (ser_const, ser_soft, mi, (shift, r), _) = got
    ja = lambda a: jnp.asarray(np.asarray(a))
    for run in range(EVAL_R):
        q_mb = np.moveaxis(f["q"][run].reshape(2, 16, N_MB, EVAL_BL), 2, 0)  # (n_mb, 2, 2n, bl)
        want = j_dp_frame_eval_mb(
            ja(q_mb), ja(f["out"][run]), ja(f["tx"][run]), ja(c.amps), ja(np.asarray(c.P, np.float32)),
            c.nu_sc, ja(f["var"]), lambda s0, ms: j_batch_cut(N_MB, EVAL_BL, s0, ms, n_cut))
        np.testing.assert_array_equal(shift[run].numpy(), np.asarray(want[3]))
        assert int(r[run]) == int(want[4])
        np.testing.assert_allclose(ser_const[run].numpy(), np.asarray(want[0]), rtol=1e-6)
        np.testing.assert_allclose(ser_soft[run].numpy(), np.asarray(want[1]), rtol=1e-6)
        # f32 sums of ~400 log2 terms in another order and memory layout
        np.testing.assert_allclose(mi[run].numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-5)
    assert shift.shape == (EVAL_R, 2)


def test_dp_step_plain_takes_per_run_variance():
    """The plain step with var (R, 2) equals R calls with each run's var."""
    const, w, h, rx, _ = _inputs("16-QAM", seed=3)
    T = torch.from_numpy
    var = torch.tensor([[0.01, 0.02], [0.03, 0.01], [0.02, 0.02]])
    args = (T(const.amps), var, const.nu_sc, T(np.asarray(const.P, np.float32)))
    x = T(rx[..., : 2 * BL].copy())
    st = dp_step_plain(T(w), T(h), x, *args)
    for r in range(R):
        one = dp_step_plain(T(w[r]), T(h[r]), x[r], args[0], var[r], *args[2:])
        np.testing.assert_allclose(st["loss"][r].numpy(), one["loss"].numpy(), rtol=1e-6)
        np.testing.assert_allclose(st["gw"][r].numpy(), one["gw"].numpy(), rtol=1e-5, atol=1e-6)
