"""Port parity: the DP butterfly, the PCS soft demapper and the DP ELBO.

Held against the JAX package on identical inputs and against the original
torch reference's fixtures (twoxtwofir.npz, soft_dec.npz, elbo_dp.npz);
torch autograd gradients of the ELBO are held against jax.grad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_equalizer_tpu.models import elbo_dp as j_elbo_dp
from vae_equalizer_tpu.models import soft_demap_dp as j_soft_demap_dp
from vae_equalizer_tpu.models import vae_le_dp_forward as j_forward
from vae_equalizer_tpu_torch.models import (
    VaeLeDp,
    butterfly_init,
    dirac_taps_dp,
    elbo_dp,
    soft_demap_dp,
    vae_le_dp_forward,
)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

T = lambda a: torch.from_numpy(np.array(a, np.float32))


def test_forward_matches_golden_and_jax(golden):
    g = golden("twoxtwofir")
    args = (g["w"], g["x"], g["amp_levels"], g["var"])
    q, out = vae_le_dp_forward(*map(T, args), float(g["nu_sc"]), 2)
    q_j, out_j = j_forward(*map(jnp.asarray, args), float(g["nu_sc"]), 2)
    # f32 FIR sums in another order than XLA's conv: ~1 ulp of O(1) outputs
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-6)
    # the softmin's 1/(2 var) gain turns those ulps into ~1e-5 on q
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), rtol=5e-4, atol=5e-5)
    # the torch reference's fixture, at the JAX package's own golden tolerance
    np.testing.assert_allclose(out.numpy(), g["out"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(q.numpy(), g["q_est"], rtol=1e-3, atol=1e-6)


def test_soft_demap_matches_golden_and_jax(golden):
    g = golden("soft_dec")
    q = soft_demap_dp(T(g["out"]), T(g["amp_levels"]), T(g["var"]), float(g["nu_sc"]))
    q_j = j_soft_demap_dp(jnp.asarray(g["out"]), jnp.asarray(g["amp_levels"]),
                          jnp.asarray(g["var"]), float(g["nu_sc"]))
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(q.numpy(), g["q"], rtol=1e-3, atol=1e-6)


def test_elbo_matches_golden_and_jax(golden):
    g = golden("elbo_dp")
    args = (g["q"], g["rx"], g["h_est"], g["amp_levels"], g["P"])
    loss, var_est = elbo_dp(*map(T, args))
    loss_j, var_j = j_elbo_dp(*map(jnp.asarray, args))
    # C = ||rx||^2 - 2<rx,D> + ||D||^2 + E sums ~100 terms in f32
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(var_est.numpy(), np.asarray(var_j), rtol=1e-5)
    np.testing.assert_allclose(loss.item(), g["loss"], rtol=1e-5)
    np.testing.assert_allclose(var_est.numpy(), g["var_est"], rtol=1e-5)


@pytest.mark.parametrize("n_lev_mod", ["4-QAM", "64-QAM"])
def test_autograd_matches_jax_grad(n_lev_mod):
    """d loss / d (w, h) of forward + ELBO: torch autograd vs jax.grad."""
    from vae_equalizer_tpu.core import make_constellation

    const = make_constellation(n_lev_mod, 0.0)
    rng = np.random.default_rng(3)
    M, bl = 25, 50
    w = np.asarray(butterfly_init(M)) + 0.01 * rng.normal(size=(2, 4, M)).astype(np.float32)
    h = np.asarray(dirac_taps_dp(M)) + 0.01 * rng.normal(size=(2, 2, 2, M)).astype(np.float32)
    x = 0.5 * rng.normal(size=(2, 2, 2 * bl)).astype(np.float32)
    amps, P = const.amps, np.asarray(const.P, np.float32)
    var = np.full(2, 0.01, np.float32)

    def j_loss(w_, h_):
        q, _ = j_forward(w_, jnp.asarray(x), jnp.asarray(amps), jnp.asarray(var), const.nu_sc, 2)
        return j_elbo_dp(q, jnp.asarray(x), h_, jnp.asarray(amps), jnp.asarray(P))[0]

    gw_j, gh_j = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(h))
    model = VaeLeDp(M)
    with torch.no_grad():
        model.w.copy_(T(w))
        model.h.copy_(T(h))
    q, _ = model(T(x), T(amps), T(var), const.nu_sc)
    loss, _ = elbo_dp(q, T(x), model.h, T(amps), T(P))
    loss.backward()
    # gradients are sums of ~1e4 f32 products with O(1e3) loss scale; relative
    # to the largest component, agreement at 1e-4 is f32 reduction noise
    for got, want in ((model.w.grad, gw_j), (model.h.grad, gh_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4 * np.abs(want).max())
