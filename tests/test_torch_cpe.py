"""Port parity: DP carrier-phase estimation (``metrics/cpe.py: cpe_dp``).

Against the reference fixture (cpe_dp.npz, the JAX package's tolerance
rtol 2e-4 / atol 2e-5, tests/test_metrics.py) and against JAX ``cpe_dp`` on
seeded frames whose phase drifts through several +-pi/2 jumps of the
4th-power estimator, so the unwrap runs.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_equalizer_tpu.metrics.cpe import cpe_dp as j_cpe_dp
from vae_equalizer_tpu_torch.metrics import cpe_dp
from vae_equalizer_tpu_torch.metrics.cpe import _moving_average, _pow4, _unwrap_quarter

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

T = torch.from_numpy


def test_cpe_dp_matches_golden(golden):
    g = golden("cpe_dp")
    got = cpe_dp(T(g["y"]))
    np.testing.assert_allclose(got.numpy(), g["y_corr"], rtol=2e-4, atol=2e-5)
    # a leading runs axis: each run as alone
    both = cpe_dp(torch.stack([T(g["y"]), -T(g["y"])]))
    np.testing.assert_array_equal(both[0].numpy(), got.numpy())


def _drifting_frame(seed, n, turns):
    """R = 2 runs of 16-QAM DP symbols with a phase that turns `turns` times
    over the frame, plus noise."""
    rng = np.random.default_rng(seed)
    lev = np.array([-3, -1, 1, 3], np.float64) / math.sqrt(10)
    sym = lev[rng.integers(0, 4, size=(2, 2, 2, n))]
    z = sym[..., 0, :] + 1j * sym[..., 1, :]
    phase = 2 * np.pi * turns * np.arange(n) / n + rng.uniform(0, 2 * np.pi, size=(2, 2, 1))
    z = z * np.exp(1j * phase) + 0.03 * (rng.normal(size=z.shape) + 1j * rng.normal(size=z.shape))
    return np.stack([z.real, z.imag], axis=-2).astype(np.float32)


@pytest.mark.parametrize("turns", [0.8, 2.5])
def test_cpe_dp_matches_jax_across_quarter_jumps(turns):
    y = _drifting_frame(3, 3000, turns)
    got = cpe_dp(T(y))
    # the unwrap runs: the raw estimate jumps by ~pi/2 somewhere in every pol
    a, b = T(y)[..., 0, :], T(y)[..., 1, :]
    ma = _moving_average(torch.stack(_pow4(a, b), dim=-2))
    phi = torch.atan2(ma[..., 1, :], -ma[..., 0, :]) / 4
    jumps = (phi.diff(dim=-1).abs() > math.pi / 4).sum(dim=-1)
    assert bool((jumps > 0).all()), jumps
    assert not torch.equal(_unwrap_quarter(phi), phi)
    for r in range(2):
        want = np.asarray(j_cpe_dp(jnp.asarray(y[r])))
        np.testing.assert_allclose(got[r].numpy(), want, rtol=2e-4, atol=2e-5)
