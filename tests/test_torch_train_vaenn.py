"""Port parity for the slice as a whole: ``train_vae_nn_awgn`` (Net and Net_BN).

The JAX experiment runs in loop mode (``use_pallas=False``); the port's runs
on the CPU in loop mode and in frame mode (kernel H's plain engine), fed the
very channel draws the JAX loop makes from its key chain
(vae_equalizer_tpu/train/awgn.py:137-148 and :558-562) through the ``draws``
seam, from the JAX package's own initial weights. Frame mode draws every
epoch's data up front by (kind, index), so on the same draws it reproduces
the loop eval for eval.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_run_sharding import check_mesh_argument
from vae_equalizer_tpu.core.constellation import sample_levels as j_sample_levels
from vae_equalizer_tpu.models import dirac_taps_siso as j_dirac_taps_siso
from vae_equalizer_tpu.models import vae_nn_init as j_vae_nn_init
from vae_equalizer_tpu.train.awgn import train_vae_nn_awgn as j_train_vae_nn_awgn
from vae_equalizer_tpu.utils.config import AwgnVaeNnConfig as JAwgnVaeNnConfig
from vae_equalizer_tpu_torch.channels import channel_ir, make_awgn_simulator
from vae_equalizer_tpu_torch.core import make_constellation
from vae_equalizer_tpu_torch.train.awgn import train_vae_nn_awgn
from vae_equalizer_tpu_torch.utils import AwgnVaeNnConfig
from vae_equalizer_tpu_torch.utils.convert import nn_params_from_jax

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

TINY = dict(mod="4-QAM", snr_db=10.0, lr=4e-3, num_epochs=6, epe=2, n_train=200, batch_len=100,
            n_valid=1000, m_est=9, kernel_1=7)


def _jax_loop_draws(cfg, key, runs):
    """The per-epoch / per-eval, per-run draws of JAX's loop mode (runs=None: one run)."""
    const = make_constellation(cfg.mod, 0.0)
    h_up, m_orig = channel_ir(cfg.channel, cfg.sps)
    sims = {kind: make_awgn_simulator(const, cfg.snr_db, h_up, m_orig, n, cfg.sps, fixed_noise=True)
            for kind, n in (("train", cfg.n_train), ("valid", cfg.n_valid))}
    amps, P = jnp.asarray(const.amps), jnp.asarray(const.P, jnp.float32)

    def frame(k, kind):
        lev, noi = [], []
        for rkey in (jax.random.split(k, runs) if runs else [k]):
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
    return lambda kind, index, R: out[kind][index]


def _reference(batchnorm: bool, runs):
    cfg_j = JAwgnVaeNnConfig(**TINY, batchnorm=batchnorm)
    key = jax.random.PRNGKey(7)
    res_j = j_train_vae_nn_awgn(cfg_j, key, runs=runs)
    key_loop, k_init = jax.random.split(key)  # train_vae_nn_awgn's init split
    net, bn_state = j_vae_nn_init(k_init, cfg_j.kernel_1, cfg_j.kernel_2, 2, batchnorm=batchnorm)
    p0 = nn_params_from_jax({"net": {k: np.asarray(v) for k, v in net.items()},
                             "h": np.asarray(j_dirac_taps_siso(cfg_j.m_est))},
                            None if bn_state is None else {k: np.asarray(v) for k, v in bn_state.items()})
    cfg = AwgnVaeNnConfig(**TINY, batchnorm=batchnorm)
    return cfg, res_j, _jax_loop_draws(cfg, key_loop, runs), p0


@pytest.mark.parametrize("batchnorm,runs", [(False, 2), (True, None)])
def test_modes_match_jax_loop_on_jax_draws(batchnorm, runs):
    # the JAX loop's runs axis cannot carry Net_BN's state (a float momentum): one run
    cfg, res_j, draws, p0 = _reference(batchnorm, runs)
    n_evals = cfg.num_epochs // cfg.epe
    for mode in (False, "frame"):
        res = train_vae_nn_awgn(cfg, 0, device="cpu", runs=runs, use_pallas=mode, draws=draws,
                                params_init=p0)
        assert res["ser"].shape == np.asarray(res_j["ser"]).shape == ((runs,) if runs else ()) + (n_evals,)
        # 18 AMSGrad steps of float32 rounding-order drift: a decision or two
        np.testing.assert_allclose(res["ser"], np.asarray(res_j["ser"]), rtol=0, atol=2 / cfg.n_valid)
        np.testing.assert_allclose(res["mi"], np.asarray(res_j["mi"]), rtol=0, atol=5e-3)
        p_j = res_j["params"]
        for k in ("w1", "b1", "w2", "b2"):
            np.testing.assert_allclose(res["params"]["net"][k].numpy(), np.asarray(p_j["net"][k]),
                                       rtol=1e-3, atol=2e-5)
        np.testing.assert_allclose(res["params"]["h"].numpy(), np.asarray(p_j["h"]), rtol=1e-3,
                                   atol=2e-5)
        if batchnorm:
            for k in ("mean", "var"):
                np.testing.assert_allclose(res["params"]["bn"][k].numpy(), np.asarray(p_j["bn"][k]),
                                           rtol=1e-4, atol=1e-5)


def test_default_init_and_raises():
    cfg = AwgnVaeNnConfig(**{**TINY, "num_epochs": 2})
    res = train_vae_nn_awgn(cfg, 3, device="cpu", use_pallas="frame")
    assert res["ser"].shape == (1,) and np.all(np.isfinite(res["mi"]))
    assert res["params"]["net"]["w1"].shape == (4, 2, 7) and res["params"]["h"].shape == (2, 9)
    with pytest.raises(ValueError, match="no per-step kernel"):
        train_vae_nn_awgn(cfg, 0, device="cpu", use_pallas=True)
    for bad in (AwgnVaeNnConfig(**{**TINY, "kernel_2": 5}), AwgnVaeNnConfig(**{**TINY, "m_est": 8})):
        with pytest.raises(ValueError, match="kernel_2=3"):
            train_vae_nn_awgn(bad, 0, device="cpu", use_pallas="frame")
    check_mesh_argument(lambda mesh: train_vae_nn_awgn(cfg, 0, device="cpu", runs=2,
                                                       use_pallas="frame", mesh=mesh))
    for mode in (False, "frame"):  # compiled / timings: the same results bit for bit
        timings = {}
        ref = train_vae_nn_awgn(cfg, 3, device="cpu", use_pallas=mode)
        got = train_vae_nn_awgn(cfg, 3, device="cpu", use_pallas=mode, compiled=True,
                                timings=timings)
        np.testing.assert_array_equal(got["ser"], ref["ser"])
        np.testing.assert_array_equal(got["mi"], ref["mi"])
        assert all(torch.equal(got["params"]["net"][k], ref["params"]["net"][k])
                   for k in ref["params"]["net"])
        assert set(timings) == {"compile_s", "run_s"}
    if not torch.cuda.is_available():  # the card is the default, and nothing falls back
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_vae_nn_awgn(cfg, 0)
