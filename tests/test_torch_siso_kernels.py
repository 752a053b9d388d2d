"""Port parity: kernels F (one SISO minibatch) and G (a whole AWGN VAE-LE
experiment), through their plain versions on the CPU.

* ``siso_step_plain`` (the closed form that kernel F computes) against
  ``torch.autograd`` of the port's model + ELBO and against
  ``jax.value_and_grad(elbo_siso o vae_le_siso_forward)``;
* the plain G engine against JAX's ``optax.amsgrad`` step loop (the
  ``use_pallas=False`` step of ``train_vae_le_awgn``), from a fresh state and
  from a JAX state carried over mid-experiment;
* the port's AMSGrad against optax and against ``torch.optim.Adam(amsgrad=
  True)``, which computes something else;
* ``requires_cuda``: both kernels against their plain versions on the card
  (skipped without one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_equalizer_tpu.models import vae_le_siso_forward as j_forward
from vae_equalizer_tpu.models.losses import elbo_siso as j_elbo_siso
from vae_equalizer_tpu_torch.core import make_constellation
from vae_equalizer_tpu_torch.models import elbo_siso, vae_le_siso_forward
from vae_equalizer_tpu_torch.ops.elbo_siso_kernel import (
    siso_step_plain,
    vae_siso_loss_and_grad,
    vae_siso_loss_and_grad_plain,
)
from vae_equalizer_tpu_torch.ops.siso_frame_kernel import (
    amsgrad,
    siso_frame_opt_init,
    vae_siso_experiment_train,
    vae_siso_experiment_train_plain,
)
from vae_equalizer_tpu_torch.utils.convert import amsgrad_state_from_jax

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

M = 25
BL = 64  # symbols per minibatch
NB = 3  # minibatches per epoch
EPOCHS = 4
EPE = 2
LR = 5e-3
VAR = 10 ** (-20.0 / 10)
T = torch.from_numpy


def _inputs(mod, R, bl, n_rows, seed):
    const = make_constellation(mod, 0.0270955)
    rng = np.random.default_rng(seed)
    w = np.zeros((R, 1, 2, M), np.float32)
    w[:, 0, 0, M // 2] = 1.0
    w += 0.01 * rng.normal(size=w.shape).astype(np.float32)
    h = np.zeros((R, 2, M), np.float32)
    h[:, 0, M // 2] = 1.0
    h += 0.01 * rng.normal(size=h.shape).astype(np.float32)
    x = (0.5 * rng.normal(size=(R,) + n_rows + (2, 2 * bl))).astype(np.float32)
    return const, w, h, x


def _jax_loss(const):
    amps, P = jnp.asarray(const.amps), jnp.asarray(const.P, jnp.float32)

    def loss_fn(p, x):
        q, _ = j_forward(p["w"], x, amps, const.amp_mean, VAR, 2)
        return j_elbo_siso(q, x, p["h"], amps, P)

    return jax.jit(jax.value_and_grad(loss_fn))


@pytest.mark.parametrize("mod", ["16-QAM", "64-QAM"])
def test_closed_form_step_matches_autograd_and_jax(mod):
    const, w, h, x = _inputs(mod, 2, 100, (), seed=11)
    amps, P = T(const.amps), T(np.asarray(const.P, np.float32))
    st = siso_step_plain(T(w), T(h), T(x), amps, const.amp_mean, VAR, P)
    assert st["q"].shape == (2, 2, amps.shape[0], 100) and st["out"].shape == (2, 2, 100)

    # torch.autograd of the port's model + ELBO, in float64
    w64, h64 = T(w).double().requires_grad_(), T(h).double().requires_grad_()
    q, _ = vae_le_siso_forward(w64, T(x).double(), amps.double(), const.amp_mean, VAR, 2)
    loss = elbo_siso(q, T(x).double(), h64, amps.double(), P.double())
    loss.sum().backward()
    # float32 closed form vs float64 autograd: the softmin's 1/var = 100 gain
    # lifts ~1e-7 rounding to ~1e-5 of the gradients' scale
    np.testing.assert_allclose(st["loss"].numpy(), loss.detach().numpy(), rtol=1e-6)
    for g, want in ((st["gw"], w64.grad), (st["gh"], h64.grad)):
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=0, atol=2e-5 * float(want.abs().max()))

    vg = _jax_loss(const)
    for r in range(2):
        l_j, g_j = vg({"w": jnp.asarray(w[r]), "h": jnp.asarray(h[r])}, jnp.asarray(x[r]))
        np.testing.assert_allclose(float(st["loss"][r]), float(l_j), rtol=1e-6)
        for g, k in ((st["gw"][r], "w"), (st["gh"][r], "h")):
            want = np.asarray(g_j[k])
            np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max())

    # the kernel wrapper on CPU tensors is the plain version, with the q layout (2n, N)
    loss1, gw1, gh1, q1, out1 = vae_siso_loss_and_grad(T(w), T(h), T(x), amps, const.amp_mean, VAR, P)
    assert q1.shape == (2, 2 * amps.shape[0], 100)
    np.testing.assert_array_equal(gw1.numpy(), st["gw"].numpy())


def _jax_amsgrad_loop(const, w, h, rx, epochs, state=None):
    """JAX's per-minibatch path: value_and_grad + optax.amsgrad, per run."""
    vg = _jax_loss(const)
    opt = optax.amsgrad(LR)
    out = []
    for r in range(w.shape[0]):
        params = {"w": jnp.asarray(w[r]), "h": jnp.asarray(h[r])}
        s = opt.init(params) if state is None else state[r]
        losses, snaps, states = [], [], []
        for e in epochs:
            for b in range(NB):
                loss, g = vg(params, jnp.asarray(rx[r, e, :, b * 2 * BL : (b + 1) * 2 * BL]))
                updates, s = opt.update(g, s, params)
                params = optax.apply_updates(params, updates)
                losses.append(float(loss))
            snaps.append((np.asarray(params["w"]), np.asarray(params["h"])))
            states.append(s)
        out.append((losses, snaps, states))
    return out


def test_plain_experiment_engine_matches_optax_loop():
    const, w, h, rx = _inputs("16-QAM", 2, NB * BL, (EPOCHS,), seed=17)  # NB minibatches a row
    amps, P = T(const.amps), T(np.asarray(const.P, np.float32))
    ref = _jax_amsgrad_loop(const, w, h, rx, range(EPOCHS))
    args = (amps, const.amp_mean, VAR, P, LR)
    kw = dict(bl_sym=BL, n_batches=NB, epe=EPE)
    w1, h1, opt1, losses, w_ev, h_ev = vae_siso_experiment_train_plain(
        T(w), T(h), siso_frame_opt_init({"w": T(w), "h": T(h)}), T(rx), *args, **kw)
    n_evals = EPOCHS // EPE
    assert losses.shape == (EPOCHS * NB, 2)
    assert w_ev.shape == (n_evals + 1, 2, 1, 2, M) and h_ev.shape == (n_evals + 1, 2, 2, M)
    for r, (l_ref, snaps, states) in enumerate(ref):
        # the tolerances of tests/test_siso_frame_kernel.py:72-85: 12 AMSGrad
        # steps of float32 reduction-order drift between two formulations
        np.testing.assert_allclose(losses[:, r].numpy(), l_ref, rtol=3e-5)
        np.testing.assert_allclose(w1[r].numpy(), snaps[-1][0], rtol=5e-3, atol=5e-6)
        np.testing.assert_allclose(h1[r].numpy(), snaps[-1][1], rtol=5e-3, atol=5e-6)
        for i in range(n_evals):  # slot i == params after epoch i*epe (0-based)
            np.testing.assert_allclose(w_ev[i, r].numpy(), snaps[i * EPE][0], rtol=5e-3, atol=5e-6)
            np.testing.assert_allclose(h_ev[i, r].numpy(), snaps[i * EPE][1], rtol=5e-3, atol=5e-6)
        np.testing.assert_array_equal(w_ev[-1, r].numpy(), w1[r].numpy())
        moments, count = amsgrad_state_from_jax(states[-1][0])
        assert count == EPOCHS * NB
        for k in ("vw", "xw", "vh", "xh"):
            np.testing.assert_allclose(opt1[k][r].numpy(), moments[k].numpy(), rtol=2e-2,
                                       atol=1e-3 * float(moments[k].abs().max()))

    # resume from JAX's state after epoch 1: the carried moments and step count
    # continue the same trajectory
    mid = [states[1] for _, _, states in ref]
    moments = [amsgrad_state_from_jax(s) for s in mid]
    opt_mid = {k: torch.stack([m[0][k] for m in moments]) for k in moments[0][0]}
    step0 = moments[0][1]
    assert step0 == 2 * NB
    w_mid = np.stack([snaps[1][0] for _, snaps, _ in ref])
    h_mid = np.stack([snaps[1][1] for _, snaps, _ in ref])
    w2, h2, _, losses2, _, _ = vae_siso_experiment_train_plain(
        T(w_mid), T(h_mid), opt_mid, T(rx[:, 2:]), *args, **kw, step0=step0)
    ref2 = _jax_amsgrad_loop(const, w_mid, h_mid, rx, range(2, EPOCHS), state=mid)
    for r, (l_ref, snaps, _) in enumerate(ref2):
        np.testing.assert_allclose(losses2[:, r].numpy(), l_ref, rtol=3e-5)
        np.testing.assert_allclose(w2[r].numpy(), snaps[-1][0], rtol=5e-3, atol=5e-6)


def test_amsgrad_is_optax_not_torch_adam():
    """nu_max takes the max over the bias-corrected nu (optax); torch's
    amsgrad takes it over the raw nu and corrects afterwards. A large early
    gradient followed by small ones tells them apart."""
    grads = [np.array([5.0, -3.0, 0.5], np.float32)] + [np.array([0.1, 0.2, -0.1], np.float32)] * 30
    lr = 1e-2
    p = torch.zeros(3)
    mu, nu, nu_max = torch.zeros(3), torch.zeros(3), torch.zeros(3)
    opt = optax.amsgrad(lr)
    pj = jnp.zeros(3)
    s = opt.init(pj)
    pt = torch.zeros(3, requires_grad=True)
    t_opt = torch.optim.Adam([pt], lr=lr, amsgrad=True)
    for step, g in enumerate(grads):
        p, mu, nu, nu_max = amsgrad(p, mu, nu, nu_max, T(g), lr, step)
        u, s = opt.update(jnp.asarray(g), s, pj)
        pj = optax.apply_updates(pj, u)
        pt.grad = T(g).clone()
        t_opt.step()
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), rtol=1e-5, atol=1e-7)
    assert np.abs(pt.detach().numpy() - np.asarray(pj)).max() > 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ for sm_90a)")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mod,bl", [("16-QAM", 64), ("64-QAM", 350)])
def test_step_kernel_matches_plain_on_card(cuda, mod, bl):
    const, w, h, x = _inputs(mod, 3, bl, (), seed=23)
    args = (T(w).to(cuda), T(h).to(cuda), T(x).to(cuda), T(const.amps).to(cuda), const.amp_mean, VAR,
            T(np.asarray(const.P, np.float32)).to(cuda))
    n0 = vae_siso_loss_and_grad.launches
    got = vae_siso_loss_and_grad(*args)
    torch.cuda.synchronize()
    assert vae_siso_loss_and_grad.launches == n0 + 1
    want = vae_siso_loss_and_grad_plain(*args)
    # float32 sums in another order, through the softmin's 1/var gain
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), wv.cpu().numpy(), rtol=1e-4,
                                   atol=1e-4 * float(wv.abs().max()))


@pytest.mark.requires_cuda
def test_experiment_kernel_matches_plain_on_card(cuda):
    const, w, h, rx = _inputs("64-QAM", 3, NB * 128, (EPOCHS,), seed=29)
    d = lambda a: T(np.ascontiguousarray(a)).to(cuda)
    wt, ht = d(w), d(h)
    args = (wt, ht, siso_frame_opt_init({"w": wt, "h": ht}), d(rx), d(const.amps), const.amp_mean,
            VAR, d(np.asarray(const.P, np.float32)), LR)
    kw = dict(bl_sym=128, n_batches=NB, epe=EPE)
    n0 = vae_siso_experiment_train.launches
    got = vae_siso_experiment_train(*args, **kw)
    torch.cuda.synchronize()
    assert vae_siso_experiment_train.launches == n0 + 1
    want = vae_siso_experiment_train_plain(*args, **kw)
    np.testing.assert_allclose(got[3].cpu().numpy(), want[3].cpu().numpy(), rtol=1e-3)
    for i in (0, 1, 4, 5):  # w, h and the eval slots after 12 AMSGrad steps
        np.testing.assert_allclose(got[i].cpu().numpy(), want[i].cpu().numpy(), rtol=2e-2, atol=1e-4)
