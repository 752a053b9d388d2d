"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. This file
imports neither JAX nor the JAX package, so on a machine with a card and no
JAX it runs on its own:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from vae_equalizer_tpu_torch.core import demapper_noise_var, make_constellation
from vae_equalizer_tpu_torch.models import butterfly_init, dirac_taps_dp
from vae_equalizer_tpu_torch.ops.elbo_kernel import (
    VaeDpLoss,
    vae_dp_loss_and_grad,
    vae_dp_loss_and_grad_plain,
)
from vae_equalizer_tpu_torch.ops.frame_kernel import (
    frame_opt_init,
    vae_dp_frame_train,
    vae_dp_frame_train_plain,
)
from vae_equalizer_tpu_torch.train import train_vae_dp, train_vae_flex_dp
from vae_equalizer_tpu_torch.utils import DpConfig

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

M = 25


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ for sm_90a)")
    return torch.device("cuda")


def _inputs(mod, R, bl, m_max, dev, seed=7):
    const = make_constellation(mod, 0.0)
    g = torch.Generator(device=dev).manual_seed(seed)
    w = butterfly_init(M, dev) + 0.01 * torch.randn((R, 2, 4, M), generator=g, device=dev)
    h = dirac_taps_dp(M, dev) + 0.01 * torch.randn((R, 2, 2, 2, M), generator=g, device=dev)
    rx = 0.5 * torch.randn((R, 2, 2, 2 * bl * m_max), generator=g, device=dev)
    var = torch.full((2,), float(np.float32(demapper_noise_var(const, 23.0))), device=dev)
    amps = torch.from_numpy(const.amps).to(dev)
    P = torch.from_numpy(np.asarray(const.P, np.float32)).to(dev)
    return const, w, h, rx, var, amps, P


def _close(got, want, rtol, atol, name):
    np.testing.assert_allclose(got.double().cpu().numpy(), want.double().cpu().numpy(), rtol=rtol,
                               atol=atol, err_msg=name)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mod", ["4-QAM", "64-QAM"])
def test_kernel_a_matches_plain(cuda, mod):
    const, w, h, rx, var, amps, P = _inputs(mod, 1, 100, 1, cuda)
    args = (w[0].contiguous(), h[0].contiguous(), rx[0].contiguous(), amps, var, const.nu_sc, P)
    before = vae_dp_loss_and_grad.launches
    got = vae_dp_loss_and_grad(*args)
    torch.cuda.synchronize()
    assert vae_dp_loss_and_grad.launches == before + 1
    want = vae_dp_loss_and_grad_plain(*args)
    for name, a, b in zip(("loss", "var_est", "gw", "gh", "q", "out"), got, want):
        # float32 sums in another order; floor at 1e-4 of each tensor's scale
        _close(a, b, 1e-4, 1e-4 * float(b.abs().max()), name)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mod", ["4-QAM", "64-QAM"])
def test_kernel_a_runs_axis_matches_plain(cuda, mod):
    """R = 5 runs in one launch, each minibatch read in place from a window of
    the frame rows (not contiguous), as the per-step path passes it."""
    const, w, h, rx, var, amps, P = _inputs(mod, 5, 100, 3, cuda)
    args = (w, h, rx[..., 200:400], amps, var, const.nu_sc, P)
    before = vae_dp_loss_and_grad.launches
    got = vae_dp_loss_and_grad(*args)
    torch.cuda.synchronize()
    assert vae_dp_loss_and_grad.launches == before + 1
    want = vae_dp_loss_and_grad_plain(*args)
    for name, a, b in zip(("loss", "var_est", "gw", "gh", "q", "out"), got, want):
        assert a.shape == b.shape, name
        _close(a, b, 1e-4, 1e-4 * float(b.abs().max()), name)


@pytest.mark.requires_cuda
def test_kernel_a_autograd_function(cuda):
    const, w, h, rx, var, amps, P = _inputs("64-QAM", 1, 100, 1, cuda)
    wt, ht = w[0].clone().requires_grad_(), h[0].clone().requires_grad_()
    loss, _ = VaeDpLoss.apply(wt, ht, rx[0].contiguous(), amps, var, const.nu_sc, P)
    (2.0 * loss).backward()
    _, _, gw, gh, _, _ = vae_dp_loss_and_grad(w[0].contiguous(), h[0].contiguous(), rx[0].contiguous(),
                                              amps, var, const.nu_sc, P)
    _close(wt.grad, 2.0 * gw, 1e-6, 0.0, "gw")
    _close(ht.grad, 2.0 * gh, 1e-6, 0.0, "gh")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mod", ["4-QAM", "64-QAM"])
def test_kernel_b_matches_plain(cuda, mod):
    R, bl, m_max = 4, 50, 3
    const, w, h, rx, var, amps, P = _inputs(mod, R, bl, m_max, cuda)
    args = (w, h, frame_opt_init({"w": w, "h": h}), rx, amps, var, const.nu_sc, P, 2.5e-3, 5, 6.0)
    before = vae_dp_frame_train.launches
    got = vae_dp_frame_train(*args, bl_sym=bl)
    torch.cuda.synchronize()
    assert vae_dp_frame_train.launches == before + 1
    want = vae_dp_frame_train_plain(*args, bl_sym=bl)
    names = ("w", "h", "opt", "losses", "var_est", "out", "dec", "eq", "mm", "s1")
    g, wa = dict(zip(names, got)), dict(zip(names, want))
    # float32 reduction order, amplified by 3 Adam steps on near-zero taps
    for k in ("losses", "var_est", "w", "h"):
        _close(g[k], wa[k], 1e-4, 3e-7, k)
    # moments are raw gradients (scale ~1e1-1e2); the softmin gain 1/(2 var)
    # lifts output ulps to ~1e-5 of their scale
    for k in ("mw", "vw", "mh", "vh"):
        _close(g["opt"][k], wa["opt"][k], 1e-4, 1e-4 * float(wa["opt"][k].abs().max()), k)
    for k in ("out", "eq", "s1"):
        _close(g[k], wa[k], 1e-4, 1e-4, k)
    _close(g["mm"], wa["mm"], 1e-4, 5e-4, "mm")
    assert g["dec"].dtype == torch.int32
    assert float((g["dec"] == wa["dec"]).float().mean()) > 0.999


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mod", ["4-QAM", "64-QAM"])
def test_kernel_b_stride_matches_plain(cuda, mod):
    """VAEflex's overlapping windows: 4 windows of 50 symbols every 25."""
    R, bl, fs = 4, 50, 25
    const, w, h, rx, var, amps, P = _inputs(mod, R, bl, 3, cuda)
    args = (w, h, frame_opt_init({"w": w, "h": h}), rx, amps, var, const.nu_sc, P, 2.5e-3, 5, 7.0)
    got = vae_dp_frame_train(*args, bl_sym=bl, stride_sym=fs)
    torch.cuda.synchronize()
    want = vae_dp_frame_train_plain(*args, bl_sym=bl, stride_sym=fs)
    assert got[3].shape == want[3].shape == ((3 * bl - bl) // fs, R)
    for k, i in (("losses", 3), ("var_est", 4), ("w", 0), ("h", 1)):
        _close(got[i], want[i], 1e-4, 3e-7, k)
    for k, i in (("out", 5), ("eq", 7), ("s1", 9)):
        _close(got[i], want[i], 1e-4, 1e-4, k)
    assert float((got[6] == want[6]).float().mean()) > 0.999


@pytest.mark.requires_cuda
def test_step_modes_on_cuda_count_launches(cuda):
    """train_vae_dp(True) launches kernel A once per minibatch for all runs;
    train_vae_flex_dp("frame") kernel B once per frame, True kernel A once
    per window; False launches neither."""
    cfg = DpConfig(mod="16-QAM", num_frames=2, n_frame_max=1000)
    counts = lambda: (vae_dp_loss_and_grad.launches, vae_dp_frame_train.launches)
    for fn, mode, expect in ((train_vae_dp, True, (20, 0)), (train_vae_dp, False, (0, 0)),
                             (train_vae_flex_dp, "frame", (0, 2)), (train_vae_flex_dp, True, (180, 0))):
        before = counts()
        res = fn(cfg, 0, device="cuda", runs=2, use_pallas=mode)
        assert tuple(b - a for a, b in zip(before, counts())) == expect, (fn.__name__, mode)
        assert res["ser"].shape == (2, 4, 2) and np.all(np.isfinite(res["ser"]))


@pytest.mark.requires_cuda
def test_train_vae_dp_on_cuda_counts_one_launch_per_frame(cuda):
    cfg = DpConfig(mod="16-QAM", num_frames=3, n_frame_max=1000)
    before = vae_dp_frame_train.launches
    res = train_vae_dp(cfg, 0, device="cuda", runs=2)
    assert vae_dp_frame_train.launches == before + cfg.num_frames
    assert res["ser"].shape == (2, 4, 3) and np.all(np.isfinite(res["ser"]))
    assert res["params"]["w"].is_cuda
