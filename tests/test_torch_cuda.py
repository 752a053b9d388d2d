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
from vae_equalizer_tpu_torch.ops.eval_kernel import vae_dp_frame_eval
from vae_equalizer_tpu_torch.ops.frame_kernel import (
    frame_opt_init,
    vae_dp_frame_train,
    vae_dp_frame_train_plain,
)
from vae_equalizer_tpu_torch.train import dp as train_dp
from vae_equalizer_tpu_torch.train import train_vae_dp, train_vae_flex_dp
from vae_equalizer_tpu_torch.train.eval_utils import BatchCutWeight, MarginWeight
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
@pytest.mark.parametrize("mod", ["4-QAM", "64-QAM"])
def test_kernel_b_run_constants_on_cuda(cuda, mod):
    """Per-run lr / var / nu_sc / P against the plain version; constant
    vectors against the shared form and stream_bf16 against float32, bit
    for bit on the card."""
    R, bl, m_max = 4, 50, 3
    const, w, h, rx, var, amps, P = _inputs(mod, R, bl, m_max, cuda)
    shaped = make_constellation(mod, 0.0270955)
    run = dict(lr=torch.tensor([2.5e-3, 1e-3, 3e-3, 2e-3], device=cuda),
               var=var * torch.tensor([[1.0], [2.0], [0.5], [1.5]], device=cuda),
               nu_sc=torch.tensor([0.0, shaped.nu_sc] * 2, device=cuda),
               P=torch.from_numpy(np.stack([const.P, shaped.P] * 2).astype(np.float32)).to(cuda))
    args = lambda c: (w, h, frame_opt_init({"w": w, "h": h}), rx, amps, c["var"], c["nu_sc"], c["P"],
                      c["lr"], 5, 6.0)
    got = vae_dp_frame_train(*args(run), bl_sym=bl)
    torch.cuda.synchronize()
    want = vae_dp_frame_train_plain(*args(run), bl_sym=bl)
    for k, i in (("losses", 3), ("var_est", 4), ("w", 0), ("h", 1)):
        _close(got[i], want[i], 1e-4, 3e-7, k)
    for k, i in (("out", 5), ("eq", 7), ("s1", 9)):
        _close(got[i], want[i], 1e-4, 1e-4, k)
    assert float((got[6] == want[6]).float().mean()) > 0.999
    shared = dict(lr=2.5e-3, var=var, nu_sc=const.nu_sc, P=P)
    const_vec = dict(lr=torch.full((R,), 2.5e-3, device=cuda), var=var.expand(R, 2).contiguous(),
                     nu_sc=torch.full((R,), const.nu_sc, device=cuda), P=P.expand(R, -1).contiguous())
    flat = lambda res: [*res[:2], *res[2].values(), *res[3:]]
    for a, b in zip(flat(vae_dp_frame_train(*args(shared), bl_sym=bl)),
                    flat(vae_dp_frame_train(*args(const_vec), bl_sym=bl))):
        assert torch.equal(a, b)
    bf = vae_dp_frame_train(*args(run), bl_sym=bl, stream_bf16=True)
    for i in (0, 1, 3, 4, 8, 9):
        assert torch.equal(bf[i], got[i]), i
    for i in (5, 7):
        assert bf[i].dtype == torch.bfloat16 and torch.equal(bf[i], got[i].to(torch.bfloat16)), i
    assert torch.equal(bf[6].to(torch.int32), got[6])


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
    res = train_vae_dp(cfg, 0, device="cuda", runs=2, use_pallas="frame")
    assert vae_dp_frame_train.launches == before + cfg.num_frames
    assert res["ser"].shape == (2, 4, 3) and np.all(np.isfinite(res["ser"]))
    assert res["params"]["w"].is_cuda


def _b_frame(cuda, *, flex=False, bf16=False, R=8):
    """Kernel B's streams of one flagship frame (DpConfig(), R runs from the
    Dirac start; VAEflex's 990 windows with ``flex``), cropped as the runner
    crops them, and the eval's other inputs."""
    cfg = DpConfig()
    n_frame = cfg.n_frame_max // cfg.batch_len * cfg.batch_len
    const, var, sim, amps, P = train_dp._setup(cfg, n_frame, cuda)
    rx, tx, _ = sim(torch.Generator(device=cuda).manual_seed(21), float(np.float32(cfg.theta)), R)
    w = butterfly_init(M, cuda).expand(R, -1, -1, -1).contiguous()
    h = dirac_taps_dp(M, cuda).expand(R, -1, -1, -1, -1).contiguous()
    bl, fs = cfg.batch_len, cfg.flex_step
    stride = fs if flex else None
    k = vae_dp_frame_train(w, h, frame_opt_init({"w": w, "h": h}), rx, amps, var, const.nu_sc, P,
                           cfg.lr, 0, 1e9, bl_sym=bl, stride_sym=stride, stream_bf16=bf16)
    m_max = k[3].shape[0]
    if flex:
        crop0 = (bl - fs) // 2
        streams = tuple(a[..., crop0 : crop0 + fs] for a in (k[5], k[6], k[7], k[8], k[9]))
        tx, wfn = tx[..., bl // 2 : bl // 2 + m_max * fs], MarginWeight(m_max * fs)
    else:
        streams, wfn = (k[5], k[6], k[7], k[8], k[9]), BatchCutWeight(m_max, bl, cfg.n_cut)
    return (*streams, tx, amps, P, const.nu_sc, var, wfn)


def _same_eval(got, want, ctx):
    """K against the plain eval: SERs, shift and r equal, MI within 1e-6 bits."""
    for name, g, w in zip(("ser_const", "ser_soft", "mi", "shift", "r"), got, want):
        if name == "mi":
            _close(g, w, 0.0, 1e-6, f"{ctx} mi")
        else:
            assert torch.equal(g, w.to(g.dtype)), (ctx, name, g, w)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("variant", ["vae", "vae_bf16", "flex"])
def test_kernel_k_matches_plain_on_b_streams(cuda, variant):
    """Kernel K on kernel B's own streams of a flagship frame of 8 runs (the
    VAE's batch cut; bfloat16 streams; VAEflex's crop and margin mask)
    against ``_dp_frame_eval_mb`` on the same tensors, one launch."""
    args = _b_frame(cuda, flex=variant == "flex", bf16=variant == "vae_bf16")
    before = vae_dp_frame_eval.launches
    got = vae_dp_frame_eval(*args)
    torch.cuda.synchronize()
    assert vae_dp_frame_eval.launches == before + 1
    _same_eval(got, train_dp._dp_frame_eval_mb(*args), variant)
    halves = [vae_dp_frame_eval(*(a[:, sl] for a in args[:5]), args[5][sl], *args[6:])
              for sl in (slice(0, 4), slice(4, 8))]
    for i, g in enumerate(got):  # a run's results do not depend on the runs beside it
        assert torch.equal(g, torch.cat([h[i] for h in halves])), i


@pytest.mark.requires_cuda
def test_train_vae_dp_kernel_k_history(cuda, monkeypatch):
    """The flagship experiment (170 frames, 8 runs) with kernel K against the
    same call with the plain eval patched in: compiled (K captured in the
    frame's CUDA graph) SER equal, MI within 1e-6, final butterflies bit for
    bit, K launched once a frame; in the loop mode every frame's shift and r
    equal."""
    cfg = DpConfig()
    run = lambda compiled: train_vae_dp(cfg, 5, device="cuda", runs=8, use_pallas="frame",
                                        compiled=compiled)
    before = vae_dp_frame_eval.launches
    res_k = run(True)
    assert vae_dp_frame_eval.launches == before + cfg.num_frames
    recorded = {"K": [], "plain": []}
    metrics = train_dp._vae_metrics

    def record(into):
        def rec(losses, ser_const, ser_soft, mi, var_est, shift, r, *rest):
            into.append((shift.clone(), r.clone()))
            return metrics(losses, ser_const, ser_soft, mi, var_est, shift, r, *rest)
        return rec

    with monkeypatch.context() as mp:
        mp.setattr(train_dp, "_vae_metrics", record(recorded["K"]))
        run(False)
    with monkeypatch.context() as mp:
        mp.setattr(train_dp, "vae_dp_frame_eval", train_dp._dp_frame_eval_mb)
        res_p = run(True)
        mp.setattr(train_dp, "_vae_metrics", record(recorded["plain"]))
        run(False)
    assert np.array_equal(res_k["ser"], res_p["ser"])
    np.testing.assert_allclose(res_k["mi"], res_p["mi"], rtol=0, atol=1e-6)
    for key in ("w", "h"):
        assert torch.equal(res_k["params"][key], res_p["params"][key])
    assert len(recorded["K"]) == len(recorded["plain"]) == cfg.num_frames
    for f, ((sk, rk), (sp, rp)) in enumerate(zip(recorded["K"], recorded["plain"])):
        assert torch.equal(sk, sp.to(sk.dtype)) and torch.equal(rk, rp.to(rk.dtype)), f
