"""Port parity for VAEflex: ``train_vae_flex_dp`` in its three modes and
kernel B's ``stride_sym`` form (overlapping windows).

Kernel B's plain version with a stride is held against the JAX frame kernel
in interpret mode; the experiment, on the CPU, against the JAX package's
per-step VAEflex path on the JAX simulator's draws (as
tests/test_torch_train_dp.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_run_sharding import check_mesh_argument
from test_torch_train_dp import RUNS, _jax_draws
from vae_equalizer_tpu.ops.frame_kernel import frame_opt_init as j_frame_opt_init
from vae_equalizer_tpu.ops.frame_kernel import vae_dp_frame_train_pallas_rb
from vae_equalizer_tpu.train.dp import train_vae_flex_dp as j_train_vae_flex_dp
from vae_equalizer_tpu.utils.config import DpConfig as JDpConfig
from vae_equalizer_tpu_torch.core import demapper_noise_var, make_constellation
from vae_equalizer_tpu_torch.models import butterfly_init, dirac_taps_dp
from vae_equalizer_tpu_torch.ops.elbo_kernel import vae_dp_loss_and_grad
from vae_equalizer_tpu_torch.ops.frame_kernel import (
    frame_opt_init,
    vae_dp_frame_train,
    vae_dp_frame_train_plain,
)
from vae_equalizer_tpu_torch.train import train_vae_flex_dp
from vae_equalizer_tpu_torch.train.dp import _setup
from vae_equalizer_tpu_torch.utils import DpConfig

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the shapes of tests/test_frame_kernel.py:299: 150 symbols, windows of 50
# every 25 -> (150 - 50) // 25 = 4 windows
M, BL, FS, N_SYM, R, LR = 25, 50, 25, 150, 2, 2.5e-3
STEP0, LR_HALF = 5, 7.0  # global steps 5-8: the w lr halves at the third window
# the JAX test's VAEflex toy (tests/test_frame_kernel.py:190-192): 200 symbols,
# windows of 40 every 20 -> 8 windows per frame
FLEX = dict(mod="4-QAM", num_frames=2, n_frame_max=200, batch_len=40, flex_step=20)


def _inputs(mod, seed=13):
    const = make_constellation(mod, 0.0)
    rng = np.random.default_rng(seed)
    w = (butterfly_init(M).numpy() + 0.01 * rng.normal(size=(R, 2, 4, M))).astype(np.float32)
    h = (dirac_taps_dp(M).numpy() + 0.01 * rng.normal(size=(R, 2, 2, 2, M))).astype(np.float32)
    rx = (0.5 * rng.normal(size=(R, 2, 2, 2 * N_SYM))).astype(np.float32)
    var = np.full(2, demapper_noise_var(const, 23.0), np.float32)
    return const, w, h, rx, var


def test_plain_stride_frame_matches_jax_frame_kernel():
    """(b) Kernel B's plain version with stride_sym against JAX's runs-batched
    frame kernel with the same stride (interpret mode), across the lr halving."""
    const, w, h, rx, var = _inputs("64-QAM")
    opt = j_frame_opt_init({"w": jnp.asarray(w), "h": jnp.asarray(h)})
    res = vae_dp_frame_train_pallas_rb(
        jnp.asarray(w), jnp.asarray(h), opt, jnp.asarray(rx), jnp.asarray(const.amps),
        jnp.asarray(var), const.nu_sc, jnp.asarray(const.P, jnp.float32), jnp.float32(LR),
        jnp.float32(STEP0), jnp.float32(LR_HALF), bl_sym=BL, stride_sym=FS, interpret=True,
        emit_eval=True, emit_q=False)
    w1, h1, opt1, losses, var_est, _, out, dec, eq, mm, s1 = res
    want = dict(w=w1, h=h1, **opt1, losses=losses, var_est=var_est, out=out,
                dec=np.asarray(dec).astype(np.int32), eq=eq, mm=mm, s1=s1)
    want = {k: np.asarray(v) for k, v in want.items()}

    T = torch.from_numpy
    wt, ht = T(w), T(h)
    before = vae_dp_frame_train.launches
    got = vae_dp_frame_train(wt, ht, frame_opt_init({"w": wt, "h": ht}), T(rx), T(const.amps),
                             T(var), const.nu_sc, T(np.asarray(const.P, np.float32)), LR, STEP0,
                             LR_HALF, bl_sym=BL, stride_sym=FS)
    assert vae_dp_frame_train.launches == before  # CPU tensors: the plain version
    w2, h2, opt2, losses2, var2, out2, dec2, eq2, mm2, s12 = got
    got = {k: v.numpy() for k, v in dict(w=w2, h=h2, **opt2, losses=losses2, var_est=var2, out=out2,
                                          dec=dec2, eq=eq2, mm=mm2, s1=s12).items()}
    m_max = (N_SYM - BL) // FS
    assert got["losses"].shape == want["losses"].shape == (m_max, R)
    assert got["out"].shape == want["out"].shape == (m_max, R, 2, 2, BL)
    # the tolerances of tests/test_torch_frame_kernel.py (no stride): f32
    # rounding in another order, amplified by 4 Adam steps
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5)
    np.testing.assert_allclose(got["var_est"], want["var_est"], rtol=2e-5)
    np.testing.assert_allclose(got["out"], want["out"], rtol=1e-4, atol=1e-6)
    for k in ("w", "h"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=3e-7, err_msg=k)
    for k in ("mw", "vw", "mh", "vh"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4 * np.abs(want[k]).max(),
                                   err_msg=k)
    np.testing.assert_allclose(got["mm"], want["mm"], rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(got["s1"], want["s1"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["eq"], want["eq"], rtol=1e-4, atol=1e-4)
    assert np.mean(got["dec"] == want["dec"]) > 0.999


def test_stride_windows_and_refusals():
    """Window m of the stride form is minibatch m of the back-to-back form
    on the rows shifted to it; both packages refuse a window length that the
    stride does not divide."""
    const, w, h, rx, var = _inputs("4-QAM", seed=2)
    T = torch.from_numpy
    consts = (T(const.amps), T(var), const.nu_sc, T(np.asarray(const.P, np.float32)), 0.0, 0, 1e9)
    wt, ht = T(w), T(h)
    opt = frame_opt_init({"w": wt, "h": ht})
    flex = vae_dp_frame_train_plain(wt, ht, opt, T(rx), *consts, bl_sym=BL, stride_sym=FS)
    # lr 0: the taps stay put, so window m sees the same taps as a
    # back-to-back frame starting at its offset
    for m in range((N_SYM - BL) // FS):
        one = vae_dp_frame_train_plain(wt, ht, opt, T(rx[..., 2 * FS * m : 2 * (FS * m + BL)].copy()),
                                       *consts, bl_sym=BL)
        np.testing.assert_array_equal(flex[3][m].numpy(), one[3][0].numpy())
        np.testing.assert_array_equal(flex[5][m].numpy(), one[5][0].numpy())
    with pytest.raises(ValueError, match="multiple of the stride"):
        vae_dp_frame_train(wt, ht, opt, T(rx), *consts, bl_sym=BL, stride_sym=20)
    jopt = j_frame_opt_init({"w": jnp.asarray(w), "h": jnp.asarray(h)})
    with pytest.raises(AssertionError, match="multiple of the stride"):
        vae_dp_frame_train_pallas_rb(
            jnp.asarray(w), jnp.asarray(h), jopt, jnp.asarray(rx), jnp.asarray(const.amps),
            jnp.asarray(var), const.nu_sc, jnp.asarray(const.P, jnp.float32), jnp.float32(0.0),
            jnp.float32(0.0), jnp.float32(1e9), bl_sym=BL, stride_sym=20, interpret=True)


def test_train_vae_flex_dp_modes_match_jax_on_jax_draws():
    """(d) All three modes on the CPU against JAX's per-step VAEflex path
    (use_pallas=False), frame for frame, on the JAX simulator's draws."""
    key = jax.random.PRNGKey(5)
    res_j = j_train_vae_flex_dp(JDpConfig(**FLEX), key, runs=RUNS, use_pallas=False)
    cfg = DpConfig(**FLEX)
    sim = _setup(cfg, cfg.n_frame_max, "cpu")[2]
    draws = _jax_draws(cfg, key, sim)
    # False: autograd through the same formulas (measured: SER equal, w
    # within 3e-5); the kernel modes round the closed form otherwise and 16
    # Adam steps amplify it — the JAX test's coarse tolerances
    # (tests/test_frame_kernel.py:198-206)
    tol = {False: dict(ser=0.01, mi=2e-3, w=1e-3), True: dict(ser=0.05, mi=0.3, w=0.05),
           "frame": dict(ser=0.05, mi=0.3, w=0.05)}
    for mode, t in tol.items():
        before = vae_dp_loss_and_grad.launches, vae_dp_frame_train.launches
        res = train_vae_flex_dp(cfg, 0, device="cpu", runs=RUNS, use_pallas=mode,
                                draws=lambda frame, r: draws[frame])
        assert (vae_dp_loss_and_grad.launches, vae_dp_frame_train.launches) == before
        assert res["ser"].shape == res_j["ser"].shape == (RUNS, 4, cfg.num_frames)
        assert res["var_est"].shape == res_j["var_est"].shape == (RUNS, 2, cfg.num_frames)
        assert np.all(np.isfinite(res["ser"])) and np.all(np.isfinite(res["mi"]))
        np.testing.assert_allclose(res["ser"], res_j["ser"], atol=t["ser"], err_msg=str(mode))
        np.testing.assert_allclose(res["mi"], res_j["mi"], rtol=t["mi"], err_msg=str(mode))
        np.testing.assert_allclose(res["params"]["w"].numpy(), np.asarray(res_j["params"]["w"]),
                                   atol=t["w"], err_msg=str(mode))


@pytest.mark.parametrize("kw", [{"checkpoint": "x.npz"}, {"checkpoint_every": 5},
                                {"stream_bf16": True}, {"lr_vec": [1e-3]}, {"snr_vec": [20.0]},
                                {"nu_vec": [0.0]}, {"mesh": object()}, {"compiled": True},
                                {"chunk_frames": 2}, {"runs_batch": 2}, {"timings": {}}])
def test_flex_deferred_options_raise(kw, tmp_path):
    """``mesh``: a non-Mesh object and an sp mesh raise ValueError, the
    one-rank CPU run mesh gives the call without one bit for bit; the
    runs-batched kernel's options, misused, raise JAX's
    ValueErrors (JAX train/dp.py:323-337, 676-677); ``checkpoint`` writes its
    state file, and ``checkpoint_every`` without a file runs; ``compiled``,
    ``chunk_frames`` and ``timings`` (with ``compiled``) run and give the
    loop mode's results bit for bit."""
    cfg = DpConfig(**FLEX)
    name = next(iter(kw))
    if name == "checkpoint":
        ckpt = tmp_path / kw[name]
        res = train_vae_flex_dp(cfg, 0, device="cpu", checkpoint=ckpt, checkpoint_every=1)
        assert ckpt.exists() and not list(tmp_path.glob("*.tmp"))
        assert np.all(np.isfinite(res["ser"]))
    elif name == "checkpoint_every":
        res = train_vae_flex_dp(cfg, 0, device="cpu", **kw)
        assert res["ser"].shape == (4, cfg.num_frames) and np.all(np.isfinite(res["ser"]))
    elif name in ("stream_bf16", "lr_vec", "snr_vec", "nu_vec"):
        with pytest.raises(ValueError, match=r"the runs-batched kernel \(set runs\)"):
            train_vae_flex_dp(cfg, 0, device="cpu", use_pallas="frame", **kw)
        if name != "stream_bf16":
            with pytest.raises(ValueError, match='need use_pallas="frame"'):
                train_vae_flex_dp(cfg, 0, device="cpu", runs=1, **kw)
    elif name == "runs_batch":
        with pytest.raises(ValueError, match="runs_batch=2 must divide runs=3"):
            train_vae_flex_dp(cfg, 0, device="cpu", use_pallas="frame", runs=3, **kw)
    elif name in ("compiled", "chunk_frames", "timings"):
        run = lambda **o: train_vae_flex_dp(cfg, 0, device="cpu", use_pallas="frame", **o)
        res = run(**kw, **({"compiled": True} if name == "timings" else {}))
        ref = run()
        for k in ("ser", "mi", "var_est"):
            np.testing.assert_array_equal(res[k], ref[k], err_msg=k)
        assert all(torch.equal(res["params"][k], ref["params"][k]) for k in ("w", "h"))
        if name == "timings":
            assert set(kw["timings"]) == {"compile_s", "run_s"}
    else:
        check_mesh_argument(lambda mesh: train_vae_flex_dp(cfg, 0, device="cpu", runs=2, mesh=mesh))


def test_flex_modes_and_device():
    """The JAX mode table (VAEflex: False, True, "frame"), the kernel modes'
    sps 2 / odd M requirement, and the card as the default device."""
    cfg = DpConfig(**FLEX)
    with pytest.raises(ValueError, match="not supported for VAEflex"):
        train_vae_flex_dp(cfg, 0, device="cpu", use_pallas="step")
    with pytest.raises(ValueError, match="sps=2 and odd M_est"):
        train_vae_flex_dp(DpConfig(**{**FLEX, "m_est": 24}), 0, device="cpu", use_pallas="frame")
    if not torch.cuda.is_available():  # the card is the default, and nothing falls back
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_vae_flex_dp(cfg, 0)
