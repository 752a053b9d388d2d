"""Port parity: the AWGN-ISI channel simulator.

The port's deterministic physics is fed the JAX simulator's own draws
(levels from ``sample_levels(k_sym, ...)``, unit noise from
``jax.random.normal(k_noise, ...)``, split from the same key as at
awgn.py:79-95) and must reproduce its (rx, tx) and its sigma (recomputed
with JAX's own ``cplx.conv_valid`` and formula, awgn.py:88-92).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_equalizer_tpu.channels import make_awgn_simulator as j_make_awgn_simulator
from vae_equalizer_tpu.core import make_constellation as j_make_constellation
from vae_equalizer_tpu.core import cplx
from vae_equalizer_tpu.core.constellation import sample_levels as j_sample_levels
from vae_equalizer_tpu.core.filters import rrcfir as j_rrcfir
from vae_equalizer_tpu_torch.channels import channel_ir, make_awgn_simulator
from vae_equalizer_tpu_torch.core import make_constellation

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N = 1500


def _jax_sigma(levels, h_up, snr_db, fixed_noise):
    """sigma as make_awgn_simulator computes it from the noise-free signal."""
    if fixed_noise:
        return np.float32(np.sqrt(1 / 2) / 10 ** (snr_db / 20))
    h_comb_c = np.convolve(np.asarray(j_rrcfir(8, 2, 0.1)).astype(np.complex64), h_up)
    h_comb = jnp.asarray(np.stack([h_comb_c.real, h_comb_c.imag]).astype(np.float32))
    n_conv = levels.shape[-1]
    tx_up = np.zeros((2, 2 * n_conv), np.float32)
    tx_up[:, ::2] = levels
    clean = cplx.conv_valid(jnp.asarray(tx_up[:, : 2 * (n_conv - 1) + 1]), h_comb)
    return float(jnp.sqrt(2 * jnp.mean(cplx.cabs2(clean)) / 2 / 10 ** (snr_db / 10)))


def _jax_draws(key, const, sim):
    k_sym, k_noise = jax.random.split(key)
    levels = j_sample_levels(k_sym, jnp.asarray(const.amps), jnp.asarray(const.P, jnp.float32),
                             (2, sim.n_conv))
    noise = jax.random.normal(k_noise, (2, sim.sig_len), jnp.float32)
    return np.array(levels), np.array(noise)


@pytest.mark.parametrize("mod,nu,channel,snr_db,fixed_noise", [
    ("64-QAM", 0.0, "h1", 24.0, False),
    ("16-QAM", 0.0270955, "h2", 18.0, False),
    ("64-QAM", 0.0, "h1", 24.0, True),
])
def test_physics_matches_jax_on_jax_draws(mod, nu, channel, snr_db, fixed_noise):
    const = make_constellation(mod, nu)
    h_up, m_orig = channel_ir(channel, 2)
    sim = make_awgn_simulator(const, snr_db, h_up, m_orig, N, 2, fixed_noise=fixed_noise)
    j_gen = jax.jit(j_make_awgn_simulator(j_make_constellation(mod, nu), snr_db, h_up, m_orig, N, 2,
                                          fixed_noise=fixed_noise))
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    draws = [_jax_draws(k, const, sim) for k in keys]
    levels = torch.from_numpy(np.stack([d[0] for d in draws]))
    noise = torch.from_numpy(np.stack([d[1] for d in draws]))
    rx, tx, sigma = sim.physics(levels, noise)
    assert rx.shape == (2, 2, 2 * N) and tx.shape == (2, 2, N) and sigma.shape == (2,)
    for r, key in enumerate(keys):
        rx_j, tx_j = (np.asarray(a) for a in j_gen(key))
        # tx is a window of the same float32 levels: exact
        np.testing.assert_array_equal(tx[r].numpy(), tx_j)
        # complex64 FFT here vs a direct f32 convolution there: sigma (a mean
        # over ~3000 samples) to ~1e-6, rx to ~1e-6 of its O(1) scale
        sig_j = _jax_sigma(draws[r][0], h_up, snr_db, fixed_noise)
        np.testing.assert_allclose(sigma[r].item(), sig_j, rtol=1e-5)
        np.testing.assert_allclose(rx[r].numpy(), rx_j, rtol=1e-4, atol=2e-5)


def test_draws_shapes_and_batch_dims():
    const = make_constellation("64-QAM", 0.0)
    h_up, m_orig = channel_ir("h1", 2)
    sim = make_awgn_simulator(const, 24.0, h_up, m_orig, N, 2)
    gen = torch.Generator().manual_seed(0)
    levels, noise = sim.draws(gen, (3, 2))
    assert levels.shape == (3, 2, 2, sim.n_conv) and noise.shape == (3, 2, 2, sim.sig_len)
    rx, tx, sigma = sim.physics(levels, noise)
    assert rx.shape == (3, 2, 2, 2 * N) and tx.shape == (3, 2, 2, N) and sigma.shape == (3, 2)
    # frames are independent: frame (1, 0) of the batch equals frame (1, 0) alone
    rx1, _, s1 = sim.physics(levels[1, 0], noise[1, 0])
    np.testing.assert_allclose(rx1.numpy(), rx[1, 0].numpy(), rtol=1e-6, atol=1e-6)
    # unit-power symbols through a unit-norm IR at 24 dB: sigma^2 = mean|rx|^2 sps / 2 / snr
    assert np.all(np.isfinite(rx.numpy())) and 0.03 < float(sigma.mean()) < 0.08
