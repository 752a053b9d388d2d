"""Port parity: the optical DP channel simulator.

The port's deterministic physics is fed the JAX simulator's own draws
(levels from ``sample_levels(k_sym, ...)``, unit noise from
``jax.random.normal(k_noise, ...)``, split from the same key as at
optical_dp.py:140-177) and must reproduce its (rx, tx, sigma).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_equalizer_tpu.channels import channel_ir as j_channel_ir
from vae_equalizer_tpu.channels import make_dp_simulator as j_make_dp_simulator
from vae_equalizer_tpu.core import make_constellation as j_make_constellation
from vae_equalizer_tpu.core.constellation import sample_levels as j_sample_levels
from vae_equalizer_tpu_torch.channels import channel_ir, make_dp_simulator
from vae_equalizer_tpu_torch.core import make_constellation
from vae_equalizer_tpu_torch.utils import DpConfig

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N = 2000


def _jax_draws(key, const, sim):
    k_sym, k_noise = jax.random.split(key)
    levels = j_sample_levels(k_sym, jnp.asarray(const.amps), jnp.asarray(const.P, jnp.float32),
                             (4, sim.n_conv))
    noise = jax.random.normal(k_noise, (2, 2, sim.sig_len), jnp.float32)
    return np.array(levels), np.array(noise)


@pytest.mark.parametrize("channel,mod", [("h0", "64-QAM"), ("h1", "16-QAM")])
def test_physics_matches_jax_on_jax_draws(channel, mod):
    cfg = DpConfig(mod=mod, channel=channel)
    const = make_constellation(cfg.mod, cfg.nu)
    h_up, _ = channel_ir(cfg.channel, cfg.sps)
    np.testing.assert_array_equal(h_up, j_channel_ir(cfg.channel, cfg.sps)[0])
    args = (cfg.snr_db, h_up, N, cfg.sps, cfg.symb_rate, cfg.tau_cd, cfg.tau_pmd, np.asarray(cfg.phi_iq))
    sim = make_dp_simulator(const, *args)
    j_gen = jax.jit(j_make_dp_simulator(j_make_constellation(cfg.mod, cfg.nu), *args))

    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    thetas = [np.float32(cfg.theta), np.float32(cfg.theta + 7 * cfg.theta_diff)]
    draws = [_jax_draws(k, const, sim) for k in keys]
    levels = torch.from_numpy(np.stack([d[0] for d in draws]))
    noise = torch.from_numpy(np.stack([d[1] for d in draws]))
    for r, (key, theta) in enumerate(zip(keys, thetas)):
        rx_j, tx_j, sig_j = (np.asarray(a) for a in j_gen(key, jnp.float32(theta)))
        rx, tx, sigma = sim.physics(theta, levels[r : r + 1], noise[r : r + 1])
        assert rx.shape == (1,) + rx_j.shape and tx.shape == (1,) + tx_j.shape
        # tx is a window of the same float32 levels: exact
        np.testing.assert_array_equal(tx[0].numpy(), tx_j)
        # complex64 FFTs (pocketfft in both, different plans) + f32 mean:
        # sigma to a few ulp, rx to ~1e-6 of its O(1) scale
        np.testing.assert_allclose(sigma[0].item(), sig_j, rtol=1e-5)
        np.testing.assert_allclose(rx[0].numpy(), rx_j, rtol=1e-4, atol=2e-5)


def test_draws_shapes_and_runs_axis():
    cfg = DpConfig()
    const = make_constellation(cfg.mod, cfg.nu)
    sim = make_dp_simulator(const, cfg.snr_db, channel_ir(cfg.channel, cfg.sps)[0], N, cfg.sps,
                            cfg.symb_rate, cfg.tau_cd, cfg.tau_pmd, np.asarray(cfg.phi_iq))
    gen = torch.Generator().manual_seed(0)
    levels, noise = sim.draws(gen, 3)
    assert levels.shape == (3, 4, sim.n_conv) and noise.shape == (3, 2, 2, sim.sig_len)
    rx, tx, sigma = sim.physics(np.float32(cfg.theta), levels, noise)
    assert rx.shape == (3, 2, 2, 2 * N) and tx.shape == (3, 2, 2, N) and sigma.shape == (3,)
    # runs are independent: run r of the batch equals run r alone
    rx1, _, s1 = sim.physics(np.float32(cfg.theta), levels[1:2], noise[1:2])
    np.testing.assert_allclose(rx1[0].numpy(), rx[1].numpy(), rtol=1e-6, atol=1e-7)
    # unit-power PCS symbols at 23 dB: sigma^2 = mean|rx|^2 sps / 2 / snr
    assert np.all(np.isfinite(rx.numpy())) and 0.05 < float(sigma.mean()) < 0.1
