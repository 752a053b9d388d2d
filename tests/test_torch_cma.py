"""Port parity: the CMA family's plain equalizers (``models/cma.py``).

``cma_dp`` / ``cma_batch_dp`` / ``cma_flex_dp`` against the reference
fixtures (cma_dp.npz, cmabatch_dp.npz, cmaflex_dp.npz) at the JAX package's
tolerances (tests/test_cma.py: out and h rtol 1e-4 / atol 1e-6, e rtol 1e-3
/ atol 1e-5), and against the JAX functions on a longer seeded frame; a
leading runs axis computes each run as alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_equalizer_tpu.models.cma import cma_batch_dp as j_cma_batch_dp
from vae_equalizer_tpu.models.cma import cma_dp as j_cma_dp
from vae_equalizer_tpu.models.cma import cma_flex_dp as j_cma_flex_dp
from vae_equalizer_tpu_torch.models import cma_batch_dp, cma_dp, cma_flex_dp, dirac_taps_dp

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

T = torch.from_numpy


def _run(name, rx, h0, lr, g, update=True, lib="torch"):
    """One fixture's variant through the port (torch) or the JAX package."""
    fns = {"torch": (cma_dp, cma_batch_dp, cma_flex_dp),
           "jax": (j_cma_dp, j_cma_batch_dp, j_cma_flex_dp)}[lib]
    conv = T if lib == "torch" else jnp.asarray
    args = (conv(rx), 1.0, conv(h0), lr)
    if name == "cma_dp":
        res = fns[0](*args, 2, update)
    elif name == "cmabatch_dp":
        res = fns[1](*args, int(g["batchlen"]), 2, update)
    else:
        res = fns[2](*args, int(g["batchlen"]), int(g["symb_step"]), 2, update)
    return [np.asarray(a) for a in res]


def _check_reference_tols(got, want):
    out, h, e = got
    np.testing.assert_allclose(out, want[0], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(h, want[1], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(e, want[2], rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("name", ["cma_dp", "cmabatch_dp", "cmaflex_dp"])
def test_cma_matches_golden(golden, name):
    g = golden(name)
    _check_reference_tols(_run(name, g["Rx"], g["h0"], float(g["lr"]), g),
                          (g["out"], g["h"], g["e"]))


@pytest.mark.parametrize("name", ["cma_dp", "cmabatch_dp", "cmaflex_dp"])
def test_runs_axis_computes_each_run_alone(golden, name):
    g = golden(name)
    rng = np.random.default_rng(4)
    rx = np.stack([g["Rx"], (1.3 * g["Rx"] + 0.05 * rng.normal(size=g["Rx"].shape)).astype(np.float32)])
    h0 = np.stack([g["h0"], (g["h0"] + 0.01 * rng.normal(size=g["h0"].shape)).astype(np.float32)])
    batched = _run(name, rx, h0, float(g["lr"]), g)
    for r in range(2):
        alone = _run(name, rx[r], h0[r], float(g["lr"]), g)
        for a, b in zip(batched, alone):
            np.testing.assert_allclose(a[r], b, rtol=1e-6, atol=1e-7)
    _check_reference_tols([a[0] for a in batched], (g["out"], g["h"], g["e"]))


@pytest.mark.parametrize("name", ["cma_dp", "cmabatch_dp", "cmaflex_dp"])
def test_cma_matches_jax_on_a_seeded_frame(golden, name):
    """1000 symbols, M = 25, from a seed: the recurrence does not amplify the
    two packages' float32 summation-order differences (~1e-6 absolute)."""
    g = dict(golden(name))
    g["batchlen"], g["symb_step"] = np.int64(100), np.int64(10 if name == "cmaflex_dp" else 100)
    rng = np.random.default_rng(7)
    rx = rng.normal(size=(2, 2, 2000)).astype(np.float32)
    h0 = (np.asarray(dirac_taps_dp(25)) + 0.01 * rng.normal(size=(2, 2, 2, 25))).astype(np.float32)
    lr = 1e-3 if name == "cma_dp" else 1e-4
    got = _run(name, rx, h0, lr, g)
    want = _run(name, rx, h0, lr, g, lib="jax")
    assert got[0].shape == want[0].shape == (2, 2, 1000) and got[2].shape == (1000, 2)
    _check_reference_tols(got, want)


def test_cma_flex_reduces_to_batch(golden):
    """flex with symb_step == batch_len is the batch variant, bit for bit."""
    g = golden("cmabatch_dp")
    b = int(g["batchlen"])
    out_b, h_b, e_b = cma_batch_dp(T(g["Rx"]), 1.0, T(g["h0"]), float(g["lr"]), b, 2, True)
    out_f, h_f, e_f = cma_flex_dp(T(g["Rx"]), 1.0, T(g["h0"]), float(g["lr"]), b, b, 2, True)
    for a, c in ((out_b, out_f), (h_b, h_f), (e_b, e_f)):
        np.testing.assert_array_equal(a.numpy(), c.numpy())


@pytest.mark.parametrize("name", ["cma_dp", "cmabatch_dp", "cmaflex_dp"])
def test_cma_eval_mode_keeps_taps(golden, name):
    g = golden(name)
    out, h, e = _run(name, g["Rx"], g["h0"], float(g["lr"]), g, update=False)
    np.testing.assert_array_equal(h, g["h0"])
    j_out, _, j_e = _run(name, g["Rx"], g["h0"], float(g["lr"]), g, update=False, lib="jax")
    np.testing.assert_allclose(out, j_out, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(e, j_e, rtol=1e-4, atol=1e-5)
