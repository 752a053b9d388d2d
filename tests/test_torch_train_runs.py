"""``train_vae_dp`` / ``train_vae_flex_dp("frame", runs=...)`` with per-run
lr / SNR / nu (``lr_vec`` / ``snr_vec`` / ``nu_vec``), ``runs_batch`` and
``stream_bf16``: the path a sweep takes when it folds a grid axis into the
runs (JAX ``_run_frame_kernel_experiment``, ``train/dp.py:334-503``).

Against JAX: one experiment with all three vectors at once, at a tiny size
(16-QAM, 200-symbol frames, bl 50, M 9, 2 frames, 4 runs, JAX's frame
kernel in interpret mode), the port fed JAX's per-run channel draws through
its ``draws`` seam. The rest holds the port against itself on the CPU (the
kernels' plain versions): constant vectors against the shared path and
``runs_batch`` splits, bit for bit; ``stream_bf16`` against float32 streams.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_equalizer_tpu.core.constellation import sample_levels as j_sample_levels
from vae_equalizer_tpu.train.dp import train_vae_dp as j_train_vae_dp
from vae_equalizer_tpu.utils.config import DpConfig as JDpConfig
from vae_equalizer_tpu_torch.core import make_constellation
from vae_equalizer_tpu_torch.train.dp import _setup, train_vae_dp, train_vae_flex_dp
from vae_equalizer_tpu_torch.utils import DpConfig

torch.set_num_threads(1)

RUNS = 4
SMALL = dict(mod="16-QAM", snr_db=20.0, num_frames=2, n_frame_max=200, batch_len=50, m_est=9,
             n_lrhalf=1)  # the w lr halves at frame 2
VECS = dict(lr_vec=[2.5e-3, 1e-3, 2.5e-3, 1e-3], snr_vec=[20.0, 20.0, 14.0, 14.0],
            nu_vec=[0.0, 0.0270955, 0.0270955, 0.0])


def _jax_draws(cfg, key, sim, nu_vec):
    """JAX's per-frame, per-run draws on its runs path (train/dp.py:450-454,
    optical_dp.py:130-144): the per-run pmf enters sample_levels traced, as
    under JAX's vmap."""
    amps = jnp.asarray(make_constellation(cfg.mod).amps)
    P_runs = jnp.asarray(np.stack([np.asarray(make_constellation(cfg.mod, nu).P, np.float32)
                                   for nu in nu_vec]))

    def one(rkey, P_r):
        k_sym, k_noise = jax.random.split(rkey)
        return (j_sample_levels(k_sym, amps, P_r, (4, sim.n_conv)),
                jax.random.normal(k_noise, (2, 2, sim.sig_len), jnp.float32))

    draw = jax.jit(jax.vmap(one))
    out = []
    for fkey in jax.random.split(key, cfg.num_frames):
        lev, noi = draw(jax.random.split(fkey, RUNS), P_runs)
        out.append((torch.from_numpy(np.array(lev)), torch.from_numpy(np.array(noi))))
    return out


def test_run_vectors_match_jax_on_jax_draws(monkeypatch):
    import vae_equalizer_tpu.ops.frame_kernel as fk

    orig = fk.vae_dp_frame_train_pallas_rb
    monkeypatch.setattr(fk, "vae_dp_frame_train_pallas_rb",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    key = jax.random.PRNGKey(7)
    res_j = j_train_vae_dp(JDpConfig(**SMALL), key, runs=RUNS, use_pallas="frame", runs_batch=2,
                           **VECS)
    cfg = DpConfig(**SMALL)
    sim = _setup(cfg, cfg.n_frame_max, "cpu")[2]
    draws = _jax_draws(cfg, key, sim, VECS["nu_vec"])
    res = train_vae_dp(cfg, 0, device="cpu", runs=RUNS, use_pallas="frame",
                       draws=lambda frame, r: draws[frame], **VECS)
    # the per-run variance is JAX's float64 host fold, to the bit
    np.testing.assert_array_equal(res["var_runs"], np.asarray(res_j["var_runs"]))
    np.testing.assert_array_equal(res["var"], np.asarray(res_j["var"]))
    assert res["ser"].shape == res_j["ser"].shape == (RUNS, 4, cfg.num_frames)
    assert np.all(np.isfinite(res["ser"])) and np.all(np.isfinite(res["mi"]))
    # at this size 8 Adam steps keep the packages' differently ordered f32
    # sums ~1e-7 apart (measured: SER equal, MI 3e-7, var_est 4e-7 relative,
    # w 6e-7); the same run with its constants' rows permuted is off by SER
    # 0.08, var_est 0.03 and w 0.016
    np.testing.assert_allclose(res["ser"], res_j["ser"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(res["mi"], res_j["mi"], rtol=1e-5)
    np.testing.assert_allclose(res["var_est"], res_j["var_est"], rtol=1e-5)
    np.testing.assert_allclose(res["params"]["w"].numpy(), np.asarray(res_j["params"]["w"]), rtol=0,
                               atol=1e-5)


def _run(fn=train_vae_dp, **kw):
    return fn(DpConfig(**SMALL), 3, device="cpu", runs=RUNS, use_pallas="frame", **kw)


def _assert_same(a, b, keys=("ser", "mi", "var_est")):
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("w", "h"):
        assert torch.equal(a["params"][k], b["params"][k]), k


@pytest.mark.parametrize("fn", [train_vae_dp, train_vae_flex_dp])
def test_constant_vectors_and_runs_batch_are_the_shared_path(fn):
    """A constant lr / SNR / nu vector equal to the config's is the shared
    path bit for bit (JAX train/dp.py:405-407), and runs_batch only splits
    the launches."""
    cfg = DpConfig(**SMALL)
    ref = _run(fn)
    assert "var_runs" not in ref
    same = _run(fn, lr_vec=[cfg.lr] * RUNS, snr_vec=[cfg.snr_db] * RUNS, nu_vec=[cfg.nu] * RUNS)
    _assert_same(same, ref)
    np.testing.assert_array_equal(same["var_runs"], np.tile(ref["var"], (RUNS, 1)))
    for rb in (1, 2):
        _assert_same(_run(fn, runs_batch=rb), ref)


def test_mixed_vectors_change_only_their_runs():
    """Runs at the config's values repeat the shared path bit for bit; runs
    at other values train and evaluate with their own constants, and report
    their own demapper variance (lower SNR or a shaped pmf)."""
    cfg = DpConfig(**SMALL)
    ref = _run()
    mixed = _run(lr_vec=[cfg.lr, cfg.lr, 1e-3, 1e-3], snr_vec=[20.0, 20.0, 20.0, 14.0],
                 nu_vec=[0.0, 0.0, 0.0270955, 0.0])
    for k in ("ser", "mi", "var_est"):
        np.testing.assert_array_equal(mixed[k][:2], ref[k][:2], err_msg=k)
        assert not np.allclose(mixed[k][2:], ref[k][2:]), k
    np.testing.assert_array_equal(mixed["var_runs"][:2], np.tile(ref["var"], (2, 1)))
    # the shaped run (nu > 0) demaps with its smaller source power, run 3 at 14 dB
    c = make_constellation(cfg.mod, 0.0270955)
    want = np.float32(c.pow_mean / 10 ** (cfg.snr_db / 10) / 2)
    np.testing.assert_array_equal(mixed["var_runs"][2], np.full(2, want))
    assert want < ref["var"][0] and np.all(mixed["var_runs"][3] > ref["var"])


def test_stream_bf16_experiment():
    """stream_bf16 leaves training untouched (parameters bit-identical) and
    moves SER / MI by less than JAX's bound for it, at JAX's test
    configuration (tests/test_frame_kernel.py:483-506: 4-QAM, 400-symbol
    frames, first-frame SER atol 2e-3, MI 2e-2)."""
    cfg = DpConfig(mod="4-QAM", num_frames=2, n_frame_max=400, batch_len=100, n_lrhalf=10**6)
    run = lambda **kw: train_vae_dp(cfg, 0, device="cpu", runs=RUNS, use_pallas="frame", **kw)
    ref, bf = run(), run(stream_bf16=True)
    for k in ("w", "h"):
        assert torch.equal(bf["params"][k], ref["params"][k]), k
    np.testing.assert_array_equal(bf["var_est"], ref["var_est"])
    np.testing.assert_allclose(bf["ser"][..., 0], ref["ser"][..., 0], atol=2e-3)
    np.testing.assert_allclose(bf["mi"], ref["mi"], rtol=2e-2, atol=2e-2)


def test_default_mode_is_jax_default():
    """use_pallas defaults to False in both runners, as in JAX
    (train/dp.py:514, 624)."""
    for fn in (train_vae_dp, train_vae_flex_dp):
        assert inspect.signature(fn).parameters["use_pallas"].default is False
    for name in ("runs_batch", "timings", "stream_bf16", "lr_vec", "snr_vec", "nu_vec"):
        assert name in inspect.signature(train_vae_dp).parameters
        assert name in inspect.signature(train_vae_flex_dp).parameters
    timings = {}  # compiled mode fills timings
    train_vae_dp(DpConfig(**SMALL), 0, device="cpu", compiled=True, timings=timings)
    assert set(timings) == {"compile_s", "run_s"} and min(timings.values()) > 0
    with pytest.raises(ValueError, match="lr_vec must have shape"):
        _run(lr_vec=[1e-3] * 3)
