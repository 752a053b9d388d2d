"""Port parity for the slice as a whole: ``train_vae_le_awgn`` in its three modes.

The JAX experiment runs in loop mode (``use_pallas=False``); the port's
experiment runs on the CPU (``use_pallas=True`` and "frame" take the
kernels' plain versions) and is fed the very channel draws the JAX loop
makes from its key chain (train/awgn.py:137-148, awgn.py:79-95), through
the ``draws`` seam. The frame mode draws its data in another order (every
epoch up front, as JAX's frame mode does with its own key streams), so it
is held to the loop mode statistically, as in tests/test_siso_frame_kernel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_run_sharding import check_mesh_argument
from vae_equalizer_tpu.core.constellation import sample_levels as j_sample_levels
from vae_equalizer_tpu.train.awgn import train_vae_le_awgn as j_train_vae_le_awgn
from vae_equalizer_tpu.utils.config import AwgnVaeLeConfig as JAwgnVaeLeConfig
from vae_equalizer_tpu_torch.train.awgn import _setup, train_vae_le_awgn
from vae_equalizer_tpu_torch.utils import AwgnVaeLeConfig
from vae_equalizer_tpu_torch.utils.convert import siso_params_from_jax

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RUNS = 2
SMALL = dict(mod="16-QAM", snr_db=20.0, lr=2e-3, num_epochs=12, epe=3, n_train=384, batch_len=128,
             n_valid=1500)


def _near_dirac(seed=0):
    """A perturbed Dirac start. From the exact Dirac taps the loss is
    invariant to the scale of w (the mean-|.| normalization), so the centre
    tap's gradient is 0 analytically: AMSGrad's first step, ~lr sign(g),
    turns its float32 rounding into a random +-lr move, and the two packages
    part at once."""
    rng = np.random.default_rng(seed)
    w = np.zeros((1, 2, 25), np.float32)
    w[0, 0, 12] = 1.0
    h = np.zeros((2, 25), np.float32)
    h[0, 12] = 1.0
    return {"w": w + 0.03 * rng.normal(size=w.shape).astype(np.float32),
            "h": h + 0.03 * rng.normal(size=h.shape).astype(np.float32)}


def _jax_loop_draws(cfg, key, sims):
    """The per-epoch / per-eval, per-run draws of JAX's loop mode with runs."""
    const = sims["train"].const
    amps, P = jnp.asarray(const.amps), jnp.asarray(const.P, jnp.float32)

    def frame(k, kind):
        lev, noi = [], []
        for rkey in jax.random.split(k, RUNS):
            k_sym, k_noise = jax.random.split(rkey)
            lev.append(np.array(j_sample_levels(k_sym, amps, P, (2, sims[kind].n_conv))))
            noi.append(np.array(jax.random.normal(k_noise, (2, sims[kind].sig_len), jnp.float32)))
        return torch.from_numpy(np.stack(lev)), torch.from_numpy(np.stack(noi))

    out = {"train": [], "valid": []}
    for epoch in range(cfg.num_epochs):
        key, k1 = jax.random.split(key)
        out["train"].append(frame(k1, "train"))
        if epoch % cfg.epe == 0:
            key, k2 = jax.random.split(key)
            out["valid"].append(frame(k2, "valid"))
    return out


@pytest.fixture(scope="module")
def jax_reference():
    key = jax.random.PRNGKey(5)
    p0 = _near_dirac()
    res_j = j_train_vae_le_awgn(JAwgnVaeLeConfig(**SMALL), key, runs=RUNS,
                                params_init={k: jnp.asarray(v) for k, v in p0.items()})
    cfg = AwgnVaeLeConfig(**SMALL)
    draws = _jax_loop_draws(cfg, key, _setup(cfg, "cpu")[1])
    return cfg, res_j, lambda kind, index, R: draws[kind][index], p0


@pytest.mark.parametrize("use_pallas", [False, True])
def test_loop_modes_match_jax_on_jax_draws(jax_reference, use_pallas):
    cfg, res_j, draws, p0 = jax_reference
    res = train_vae_le_awgn(cfg, 0, device="cpu", runs=RUNS, use_pallas=use_pallas, draws=draws, params_init=p0)
    n_evals = cfg.num_epochs // cfg.epe
    assert res["ser"].shape == res_j["ser"].shape == (RUNS, n_evals)
    assert res["mi"].shape == (RUNS, n_evals)
    assert res["params"]["w"].shape == (RUNS, 1, 2, 25) and res["params"]["h"].shape == (RUNS, 2, 25)
    # 36 AMSGrad steps of float32 rounding-order drift between the two
    # packages leave the taps ~1e-5 apart (measured 1.2e-5): a decision or two
    np.testing.assert_allclose(res["ser"], np.asarray(res_j["ser"]), rtol=0, atol=2 / cfg.n_valid)
    np.testing.assert_allclose(res["mi"], np.asarray(res_j["mi"]), rtol=0, atol=2e-3)
    p_j = siso_params_from_jax({k: np.asarray(v) for k, v in res_j["params"].items()})
    np.testing.assert_allclose(res["params"]["w"].numpy(), p_j["w"].numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(res["params"]["h"].numpy(), p_j["h"].numpy(), rtol=0, atol=1e-4)


def test_frame_mode_statistically_matches_loop():
    cfg = AwgnVaeLeConfig(mod="16-QAM", snr_db=20.0, num_epochs=20, epe=5, n_train=600,
                          batch_len=200, n_valid=2000)
    rf = train_vae_le_awgn(cfg, 0, device="cpu", use_pallas="frame")
    rl = train_vae_le_awgn(cfg, 0, device="cpu", use_pallas=True)
    assert rf["ser"].shape == rl["ser"].shape == (4,)
    assert rf["params"]["w"].shape == (1, 2, 25) and rf["params"]["h"].shape == (2, 25)
    assert np.all(np.isfinite(rf["ser"])) and np.all(np.isfinite(rf["mi"]))
    # same config, other draws: SER within the run-to-run band (the JAX
    # test's bound, tests/test_siso_frame_kernel.py:113)
    np.testing.assert_allclose(rf["ser"], rl["ser"], atol=0.1)

    # runs and groups of runs_batch: one kernel launch per group, the same
    # result (at the parity test's lr, from a perturbed start, see _near_dirac)
    cfg = AwgnVaeLeConfig(**SMALL)
    r2 = train_vae_le_awgn(cfg, 3, device="cpu", runs=2, use_pallas="frame", params_init=_near_dirac())
    r1 = train_vae_le_awgn(cfg, 3, device="cpu", runs=2, use_pallas="frame", runs_batch=1, params_init=_near_dirac())
    assert r2["ser"].shape == (2, 4) and r2["params"]["w"].shape == (2, 1, 2, 25)
    np.testing.assert_allclose(r1["ser"], r2["ser"], atol=2 / cfg.n_valid)
    np.testing.assert_allclose(r1["params"]["w"].numpy(), r2["params"]["w"].numpy(), rtol=1e-3, atol=1e-5)
    assert not np.allclose(r2["ser"][0], r2["ser"][1])  # independent draws per run


def test_options_and_modes_raise():
    """``mesh``: a non-Mesh object and an sp mesh raise ValueError, the
    one-rank CPU run mesh gives the call without one bit for bit;
    ``compiled`` and ``timings`` run, the loop mode's results bit for bit;
    bad modes and shapes raise."""
    cfg = AwgnVaeLeConfig(**SMALL)
    check_mesh_argument(lambda mesh: train_vae_le_awgn(cfg, 0, device="cpu", runs=2,
                                                       use_pallas=True, mesh=mesh))
    ref = train_vae_le_awgn(cfg, 0, device="cpu", use_pallas=True)
    timings = {}
    for kw in ({"compiled": True}, {"compiled": True, "timings": timings}):
        res = train_vae_le_awgn(cfg, 0, device="cpu", use_pallas=True, **kw)
        np.testing.assert_array_equal(res["ser"], ref["ser"])
        np.testing.assert_array_equal(res["mi"], ref["mi"])
        assert all(torch.equal(res["params"][k], ref["params"][k]) for k in ("w", "h"))
    assert set(timings) == {"compile_s", "run_s"}
    for mode in (True, "frame"):
        for bad in (AwgnVaeLeConfig(**{**SMALL, "sps": 1}), AwgnVaeLeConfig(**{**SMALL, "m_est": 24})):
            with pytest.raises(ValueError, match="sps=2 and odd M_est"):
                train_vae_le_awgn(bad, 0, device="cpu", use_pallas=mode)
    with pytest.raises(ValueError, match="runs_batch"):
        train_vae_le_awgn(cfg, 0, device="cpu", runs=3, runs_batch=2, use_pallas="frame")
