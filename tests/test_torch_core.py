"""Port parity: constellations, PCS sampling and pulse filters.

vae_equalizer_tpu_torch.core against the JAX package's core and the torch
reference fixtures (tests/golden/filters.npz, init_*.npz). The constants are
built with the same float64 NumPy code in both packages, so most checks are
exact.
"""

import jax
import numpy as np
import pytest
import torch

from vae_equalizer_tpu.core import constellation as jcon
from vae_equalizer_tpu.core import filters as jfil
from vae_equalizer_tpu_torch.core import (
    demapper_noise_var,
    levels_from_uniform,
    make_constellation,
    rcfir,
    rrcfir,
    sample_levels,
)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MODS = ["4-QAM", "16-QAM", "64-QAM"]
NUS = [0.0, 0.0270955, 0.1222578]


def test_filters_match_golden_and_jax(golden):
    g = golden("filters")
    cases = {"rrc_T8_sps2_b01": (rrcfir, 8, 2, 0.1), "rc_T8_sps2_b01": (rcfir, 8, 2, 0.1),
             "rrc_T8_sps1_b01": (rrcfir, 8, 1, 0.1), "rc_T8_sps1_b01": (rcfir, 8, 1, 0.1),
             "rrc_T6_sps4_b025": (rrcfir, 6, 4, 0.25)}
    for name, (fn, T, sps, beta) in cases.items():
        got = fn(T, sps, beta)
        # same NumPy float64 arithmetic as the JAX package: bit-identical
        np.testing.assert_array_equal(got, getattr(jfil, fn.__name__)(T, sps, beta))
        # the reference's torch fixtures: float32 rounding of the design
        np.testing.assert_allclose(got, g[name], rtol=1e-6)


@pytest.mark.parametrize("mod", MODS)
@pytest.mark.parametrize("nu", NUS)
def test_constellation_matches_golden_and_jax(golden, mod, nu):
    g = golden(f"init_{mod}_{nu}")
    c = make_constellation(mod, nu)
    j = jcon.make_constellation(mod, nu)
    # identical float64 host code: exact equality with the JAX package
    np.testing.assert_array_equal(c.amps, j.amps)
    np.testing.assert_array_equal(c.P, j.P)
    np.testing.assert_array_equal(c.points, j.points)
    assert (c.nu_sc, c.pow_mean, c.amp_mean, c.entropy) == (j.nu_sc, j.pow_mean, j.amp_mean, j.entropy)
    assert demapper_noise_var(c, 23.0) == jcon.demapper_noise_var(j, 23.0)
    # the torch reference stores float64 constants; ours are the float32 cast
    np.testing.assert_allclose(c.amps, g["amps"], rtol=1e-6)
    np.testing.assert_allclose(c.P, g["P"], rtol=1e-6)
    np.testing.assert_allclose(c.nu_sc, g["nu_sc"], rtol=1e-6)
    np.testing.assert_allclose(c.pow_mean, g["pow_mean"], rtol=1e-6)


@pytest.mark.parametrize("mod,nu", [("4-QAM", 0.0), ("64-QAM", 0.0), ("64-QAM", 0.1222578)])
def test_levels_from_uniform_equals_jax_sample_levels(mod, nu):
    """The deterministic inverse CDF on JAX's own uniforms reproduces JAX's
    sample_levels bit for bit (same float32 step sums)."""
    c = make_constellation(mod, nu)
    key = jax.random.PRNGKey(4)
    shape = (4, 3000)
    want = np.asarray(jcon.sample_levels(key, c.amps, np.asarray(c.P, np.float32), shape))
    u = np.array(jax.random.uniform(key, shape))
    got = levels_from_uniform(torch.from_numpy(u), c.amps, c.P).numpy()
    np.testing.assert_array_equal(got, want)


def test_sample_levels_distribution():
    """The torch.Generator draw follows the PCS pmf (distribution check)."""
    c = make_constellation("64-QAM", 0.1222578)
    gen = torch.Generator().manual_seed(0)
    a = sample_levels(gen, c.amps, c.P, (200_000,)).numpy()
    # levels are float32 step sums (as in JAX), within 1e-6 of the grid
    lev = np.argmin(np.abs(a[:, None] - c.amps[None, :]), axis=1)
    assert np.max(np.abs(a - c.amps[lev])) < 1e-6
    freq = np.bincount(lev, minlength=c.num_lev) / a.size
    # 200k draws: binomial std <= sqrt(p/200k) ~ 1e-3; 5 sigma bound
    np.testing.assert_allclose(freq, c.P, atol=5e-3)
