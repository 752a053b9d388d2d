"""Kernel A's plain version (one DP minibatch: loss, var_est, gw, gh, q, out).

Held against the JAX closed form (ops/elbo_vjp.py vae_dp_loss_fwd/bwd) and
against torch autograd through the port's model + ELBO, at 4- and 64-QAM
with bl = 50. On the CPU the wrapper and the autograd node take the plain
version and never count a launch; the CUDA kernel itself is compared with
the plain version in tests/test_torch_cuda.py (and by chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_equalizer_tpu.ops.elbo_vjp import vae_dp_loss_bwd, vae_dp_loss_fwd
from vae_equalizer_tpu_torch.core import demapper_noise_var, make_constellation
from vae_equalizer_tpu_torch.models import butterfly_init, dirac_taps_dp, elbo_dp, vae_le_dp_forward
from vae_equalizer_tpu_torch.ops.elbo_kernel import (
    VaeDpLoss,
    vae_dp_loss_and_grad,
    vae_dp_loss_and_grad_plain,
)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

M, BL = 25, 50


def _inputs(mod, seed=7):
    const = make_constellation(mod, 0.0)
    rng = np.random.default_rng(seed)
    w = butterfly_init(M).numpy() + 0.01 * rng.normal(size=(2, 4, M)).astype(np.float32)
    h = dirac_taps_dp(M).numpy() + 0.01 * rng.normal(size=(2, 2, 2, M)).astype(np.float32)
    x = (0.5 * rng.normal(size=(2, 2, 2 * BL))).astype(np.float32)
    var = np.full(2, demapper_noise_var(const, 23.0), np.float32)
    return const, w, h, x, const.amps, np.asarray(const.P, np.float32), var


def _rel_max(got, want):
    got, want = (a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a) for a in (got, want))
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("mod", ["4-QAM", "64-QAM"])
def test_plain_matches_jax_closed_form(mod):
    const, w, h, x, amps, P, var = _inputs(mod)
    jargs = [jnp.asarray(a) for a in (w, h, x, amps)] + [jnp.asarray(var), const.nu_sc, jnp.asarray(P)]
    (loss_j, var_j), res = vae_dp_loss_fwd(*jargs)
    gw_j, gh_j = vae_dp_loss_bwd(*jargs, res)
    q_j, out_j = res[0], res[1]
    T = torch.from_numpy
    loss, var_est, gw, gh, q, out = vae_dp_loss_and_grad_plain(
        T(w), T(h), T(x), T(amps), T(var), const.nu_sc, T(P))
    assert q.shape == (2, 2 * const.num_lev, BL) and out.shape == (2, 2, BL)
    # loss/var_est: the port sums C as (rx - D)^2 where JAX expands it; the
    # two f32 roundings differ by ~1e-6 relative at these magnitudes
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=2e-5)
    np.testing.assert_allclose(var_est.numpy(), np.asarray(var_j), rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-6)
    # softmin gain 1/(2 var) ~ 250 amplifies ~1 ulp output differences
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), rtol=5e-4, atol=5e-5)
    # gradients: f32 sums of ~1e4 products in another order, relative to the
    # largest component
    assert _rel_max(gw, gw_j) < 1e-4
    assert _rel_max(gh, gh_j) < 1e-4


@pytest.mark.parametrize("mod", ["4-QAM", "64-QAM"])
def test_plain_matches_torch_autograd(mod):
    const, w, h, x, amps, P, var = _inputs(mod, seed=3)
    T = torch.from_numpy
    wt, ht = T(w).requires_grad_(), T(h).requires_grad_()
    q, _ = vae_le_dp_forward(wt, T(x), T(amps), T(var), const.nu_sc, 2)
    loss_ref, _ = elbo_dp(q, T(x), ht, T(amps), T(P))
    loss_ref.backward()
    loss, _, gw, gh, _, _ = vae_dp_loss_and_grad_plain(T(w), T(h), T(x), T(amps), T(var),
                                                      const.nu_sc, T(P))
    np.testing.assert_allclose(loss.item(), loss_ref.item(), rtol=2e-5)
    assert _rel_max(gw, wt.grad) < 1e-4
    assert _rel_max(gh, ht.grad) < 1e-4


def test_autograd_function_and_cpu_dispatch():
    """VaeDpLoss on CPU: forward = the plain loss, backward = g * (gw, gh);
    the wrapper takes the plain version and counts no launch."""
    const, w, h, x, amps, P, var = _inputs("64-QAM", seed=5)
    T = torch.from_numpy
    before = vae_dp_loss_and_grad.launches
    wt, ht = T(w).requires_grad_(), T(h).requires_grad_()
    loss, var_est = VaeDpLoss.apply(wt, ht, T(x), T(amps), T(var), const.nu_sc, T(P))
    (3.0 * loss).backward()
    want = vae_dp_loss_and_grad_plain(T(w), T(h), T(x), T(amps), T(var), const.nu_sc, T(P))
    assert loss.item() == want[0].item()
    np.testing.assert_array_equal(var_est.numpy(), want[1].numpy())
    assert not var_est.requires_grad
    np.testing.assert_allclose(wt.grad.numpy(), 3.0 * want[2].numpy(), rtol=1e-6)
    np.testing.assert_allclose(ht.grad.numpy(), 3.0 * want[3].numpy(), rtol=1e-6)
    assert vae_dp_loss_and_grad.launches == before
