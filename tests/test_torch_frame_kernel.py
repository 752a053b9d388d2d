"""Kernel B's plain version (one training frame for R runs) against the JAX
frame kernel in interpret mode.

Inputs are made with numpy from a seed and fed to both:
``vae_dp_frame_train_pallas_rb(..., interpret=True, emit_eval=True,
emit_q=False)`` and the port's ``vae_dp_frame_train`` on CPU tensors (its
plain version: a Python loop of kernel A's plain step plus explicit Adam).
R = 2, bl = 50, m_max = 3, and the frame crosses ``lr_half_step``. The CUDA
kernel is compared with the plain version in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_equalizer_tpu.ops.frame_kernel import frame_opt_init as j_frame_opt_init
from vae_equalizer_tpu.ops.frame_kernel import vae_dp_frame_train_pallas_rb
from vae_equalizer_tpu_torch.core import demapper_noise_var, make_constellation
from vae_equalizer_tpu_torch.models import butterfly_init, dirac_taps_dp
from vae_equalizer_tpu_torch.ops.frame_kernel import (
    frame_opt_init,
    vae_dp_frame_train,
    vae_dp_frame_train_plain,
)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

M, BL, M_MAX, R, LR = 25, 50, 3, 2, 2.5e-3
STEP0, LR_HALF = 5, 6.0  # global steps 5, 6, 7: the w lr halves at the second step


def _inputs(mod, seed=11):
    const = make_constellation(mod, 0.0)
    rng = np.random.default_rng(seed)
    w = (butterfly_init(M).numpy() + 0.01 * rng.normal(size=(R, 2, 4, M))).astype(np.float32)
    h = (dirac_taps_dp(M).numpy() + 0.01 * rng.normal(size=(R, 2, 2, 2, M))).astype(np.float32)
    rx = (0.5 * rng.normal(size=(R, 2, 2, 2 * BL * M_MAX))).astype(np.float32)
    var = np.full(2, demapper_noise_var(const, 23.0), np.float32)
    return const, w, h, rx, var


def _run_jax(const, w, h, rx, var):
    opt = j_frame_opt_init({"w": jnp.asarray(w), "h": jnp.asarray(h)})
    res = vae_dp_frame_train_pallas_rb(
        jnp.asarray(w), jnp.asarray(h), opt, jnp.asarray(rx), jnp.asarray(const.amps),
        jnp.asarray(var), const.nu_sc, jnp.asarray(const.P, jnp.float32), jnp.float32(LR),
        jnp.float32(STEP0), jnp.float32(LR_HALF), bl_sym=BL, interpret=True, emit_eval=True,
        emit_q=False)
    w1, h1, opt1, losses, var_est, q, out, dec, eq, mm, s1 = res
    assert q is None
    return dict(w=w1, h=h1, **opt1, losses=losses, var_est=var_est, out=out,
                dec=np.asarray(dec).astype(np.int32), eq=eq, mm=mm, s1=s1)


def _run_port(fn, const, w, h, rx, var, device="cpu"):
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    wt, ht = T(w), T(h)
    res = fn(wt, ht, frame_opt_init({"w": wt, "h": ht}), T(rx), T(const.amps), T(var),
             const.nu_sc, T(const.P), LR, STEP0, LR_HALF, bl_sym=BL)
    w1, h1, opt1, losses, var_est, out, dec, eq, mm, s1 = res
    out_d = dict(w=w1, h=h1, **opt1, losses=losses, var_est=var_est, out=out, dec=dec, eq=eq,
                 mm=mm, s1=s1)
    return {k: v.cpu().numpy() for k, v in out_d.items()}


@pytest.mark.parametrize("mod", ["4-QAM", "64-QAM"])
def test_plain_frame_matches_jax_frame_kernel(mod):
    const, w, h, rx, var = _inputs(mod)
    want = _run_jax(const, w, h, rx, var)
    before = vae_dp_frame_train.launches
    got = _run_port(vae_dp_frame_train, const, w, h, rx, var)
    assert vae_dp_frame_train.launches == before  # CPU tensors: plain version
    assert got["dec"].dtype == np.int32
    for k in ("out", "dec", "mm", "s1"):
        assert got[k].shape == (M_MAX, R, 2, 2, BL), k
    assert got["eq"].shape == (M_MAX, R, 2, BL) and got["losses"].shape == (M_MAX, R)

    # the JAX kernel folds 1/(2 var) into its demapper operands and sums via
    # batched matmuls; the port follows elbo_vjp's formulas: f32 rounding
    # differences of ~1e-6 relative, as between the JAX kernel and its step
    # path (tests/test_frame_kernel.py)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5)
    np.testing.assert_allclose(got["var_est"], want["var_est"], rtol=2e-5)
    np.testing.assert_allclose(got["out"], want["out"], rtol=1e-4, atol=1e-6)
    # 3 Adam steps amplify ~1e-7 per-step differences on near-zero taps
    for k in ("w", "h"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=3e-7, err_msg=k)
    # the moments hold the raw gradients, where the softmin gain 1/(2 var)
    # ~ 200 lifts output ulps to ~3e-5 of the largest component (measured)
    for k in ("mw", "vw", "mh", "vh"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4 * np.abs(want[k]).max(),
                                   err_msg=k)
    # demapper statistics: mm = min (out - a)^2 / (2 var) moves ~1e-4 per
    # output ulp; s1 and eq are O(1)
    np.testing.assert_allclose(got["mm"], want["mm"], rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(got["s1"], want["s1"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["eq"], want["eq"], rtol=1e-4, atol=1e-4)
    # decisions agree except where two levels' metrics tie to rounding
    assert np.mean(got["dec"] == want["dec"]) > 0.999


def test_plain_frame_counts_steps_and_halves_lr():
    """A frame split in two (step0 carried) equals the whole frame, and the
    lr halving applies to w only: with lr_half_step at 0, h's update is the
    same as with no halving while w's differs."""
    const, w, h, rx, var = _inputs("4-QAM", seed=2)
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    amps, P, v = T(const.amps), T(const.P), T(var)
    wt, ht = T(w), T(h)
    opt = frame_opt_init({"w": wt, "h": ht})
    full = vae_dp_frame_train_plain(wt, ht, opt, T(rx), amps, v, const.nu_sc, P, LR, 0, 1e9, bl_sym=BL)
    a = vae_dp_frame_train_plain(wt, ht, opt, T(rx[..., : 2 * BL]), amps, v, const.nu_sc, P, LR, 0,
                                 1e9, bl_sym=BL)
    b = vae_dp_frame_train_plain(a[0], a[1], a[2], T(rx[..., 2 * BL :]), amps, v, const.nu_sc, P,
                                 LR, 1, 1e9, bl_sym=BL)
    np.testing.assert_array_equal(b[0].numpy(), full[0].numpy())
    np.testing.assert_array_equal(torch.cat([a[3], b[3]]).numpy(), full[3].numpy())
    half = vae_dp_frame_train_plain(wt, ht, opt, T(rx[..., : 2 * BL]), amps, v, const.nu_sc, P,
                                    LR, 0, 0.0, bl_sym=BL)
    np.testing.assert_array_equal(half[1].numpy(), a[1].numpy())
    assert not np.allclose(half[0].numpy(), a[0].numpy(), rtol=0, atol=1e-9)
