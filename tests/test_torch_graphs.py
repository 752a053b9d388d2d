"""CUDA-graph replay of the port's loops (``train/harness.py``): ``compiled``,
``chunk_frames`` and ``timings``.

On the CPU the graph modes call the same static-buffer step eagerly where
the card replays its capture, so these tests hold the plumbing (the frame
counter, the device tables it reads, the history rows it writes, the
warm-up's restore, the chunk boundaries) to the loop mode bit for bit:

* every runner and mode of ``train/dp.py`` and the loop modes of
  ``train/awgn.py``, compiled and chunked (a chunk length that divides the
  frame count and one that does not), against the loop mode;
* ``progress`` once per frame, in order, in chunked mode; a chunked run
  killed in ``progress`` resumes from JAX's chunk-boundary save and equals
  the uninterrupted run; ``timings``' keys, and a timed result equal to a
  plain run (which proves the reset between the timed runs); the sweep
  passes ``compiled`` on and drops ``progress``;
* the port's ``compiled=True`` on the JAX package's draws against the JAX
  package's ``compiled=True``: ``train_vae_dp(use_pallas=False)`` within
  ``tests/test_torch_train_dp.py``'s tolerances, ``train_vae_le_awgn``
  within ``tests/test_torch_train_awgn.py``'s;
* on a card (``requires_cuda``): the capture runs, replays the kernels, and
  equals the loop mode bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_dp import RUNS, _jax_draws
from vae_equalizer_tpu.core.constellation import sample_levels as j_sample_levels
from vae_equalizer_tpu.train.awgn import train_vae_le_awgn as j_train_vae_le_awgn
from vae_equalizer_tpu.train.dp import train_vae_dp as j_train_vae_dp
from vae_equalizer_tpu.utils.config import AwgnVaeLeConfig as JAwgnVaeLeConfig
from vae_equalizer_tpu.utils.config import DpConfig as JDpConfig
from vae_equalizer_tpu_torch.ops import vae_dp_frame_train
from vae_equalizer_tpu_torch.parallel import sweep
from vae_equalizer_tpu_torch.parallel.sweep import run_sweep
from vae_equalizer_tpu_torch.train import (
    run_cma_dp,
    train_vae_dp,
    train_vae_flex_dp,
    train_vae_le_awgn,
    train_vae_nn_awgn,
)
from vae_equalizer_tpu_torch.train import awgn as train_awgn
from vae_equalizer_tpu_torch.train.dp import _setup
from vae_equalizer_tpu_torch.utils import AwgnVaeLeConfig, AwgnVaeNnConfig, DpConfig
from vae_equalizer_tpu_torch.utils.convert import siso_params_from_jax

torch.set_num_threads(1)

FRAMES = 5  # chunk lengths 2 (does not divide it) and 5 (does)
DP = dict(mod="4-QAM", snr_db=20.0, num_frames=FRAMES, n_frame_max=400, batch_len=50, lr=2.5e-3,
          m_est=9, n_lrhalf=2)
CMA = dict(DP, n_frame_max=600, m_est=5, lr=1e-4, n_lrhalf=2)
AWGN = dict(mod="4-QAM", snr_db=14.0, num_epochs=7, epe=2, n_train=256, batch_len=128,
            n_valid=1000, m_est=9)  # the trailing epoch trains without an eval
NN = dict(mod="4-QAM", snr_db=10.0, lr=4e-3, num_epochs=5, epe=2, n_train=200, batch_len=100,
          n_valid=1000, m_est=9, kernel_1=7)

FRAME_CASES = {  # name -> (runner, config, kwargs)
    "vae-frame": (train_vae_dp, DpConfig(**DP), {"use_pallas": "frame"}),
    "vae-kernel-A": (train_vae_dp, DpConfig(**DP), {"use_pallas": True}),
    "vae-autograd": (train_vae_dp, DpConfig(**DP), {"use_pallas": False}),
    "vaeflex-frame": (train_vae_flex_dp, DpConfig(**{**DP, "flex_step": 25}), {"use_pallas": "frame"}),
    "vaeflex-kernel-A": (train_vae_flex_dp, DpConfig(**{**DP, "flex_step": 25}), {"use_pallas": True}),
    "vaeflex-autograd": (train_vae_flex_dp, DpConfig(**{**DP, "flex_step": 25}),
                         {"use_pallas": False}),
    "vae-frame-lr-vec": (train_vae_dp, DpConfig(**DP),
                         {"use_pallas": "frame", "lr_vec": [2.5e-3, 1e-3], "nu_vec": [0.0, 0.02]}),
    "cma-kernel-C": (run_cma_dp, DpConfig(loss_type="CMA", **CMA), {"use_pallas": True}),
    "cma-plain": (run_cma_dp, DpConfig(loss_type="CMA", **CMA), {"use_pallas": False}),
    "cmabatch-kernel-D": (run_cma_dp, DpConfig(loss_type="CMAbatch", **CMA), {"use_pallas": "frame"}),
    "cmabatch-plain": (run_cma_dp, DpConfig(loss_type="CMAbatch", **CMA), {"use_pallas": False}),
    "cmaflex-kernel-D": (run_cma_dp, DpConfig(loss_type="CMAflex", **CMA), {"use_pallas": "frame"}),
    "cmaflex-plain": (run_cma_dp, DpConfig(loss_type="CMAflex", **CMA), {"use_pallas": False}),
}
EPOCH_CASES = {
    "vaele-autograd": (train_vae_le_awgn, AwgnVaeLeConfig(**AWGN), {"use_pallas": False}),
    "vaele-kernel-F": (train_vae_le_awgn, AwgnVaeLeConfig(**AWGN), {"use_pallas": True}),
    "vaenn-loop": (train_vae_nn_awgn, AwgnVaeNnConfig(**NN), {}),
    "vaenn-bn-loop": (train_vae_nn_awgn, AwgnVaeNnConfig(**NN, batchnorm=True), {}),
}


def _assert_same(got, want, where=""):
    """Every array, tensor and number of a runner's result, bit for bit."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want), where
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


@pytest.mark.parametrize("name", list(FRAME_CASES))
def test_frame_loops_compiled_and_chunked_equal_loop(name):
    runner, cfg, kw = FRAME_CASES[name]
    run = lambda **o: runner(cfg, 3, device="cpu", runs=2, **kw, **o)  # noqa: E731
    ref = run()
    assert ref["ser"].shape == (2, 4, FRAMES) and np.all(np.isfinite(ref["ser"]))
    _assert_same(run(compiled=True), ref, "compiled")
    for k in (2, FRAMES):
        _assert_same(run(chunk_frames=k), ref, f"chunk_frames={k}")


@pytest.mark.parametrize("name", list(EPOCH_CASES))
def test_epoch_loops_compiled_equal_loop(name):
    runner, cfg, kw = EPOCH_CASES[name]
    ref = runner(cfg, 3, device="cpu", runs=2, **kw)
    assert ref["ser"].shape == (2, cfg.num_epochs // cfg.epe)
    _assert_same(runner(cfg, 3, device="cpu", runs=2, compiled=True, **kw), ref, "compiled")


def test_chunked_progress_per_frame_in_order():
    runner, cfg, kw = FRAME_CASES["vae-frame"]
    seen = []
    res = runner(cfg, 0, device="cpu", runs=2, chunk_frames=2,
                 progress=lambda i, m: seen.append((i, m)), **kw)
    assert [i for i, _ in seen] == list(range(FRAMES))
    for i, m in seen:
        np.testing.assert_array_equal(m["ser_soft"], res["ser"][:, 2:, i])
        np.testing.assert_array_equal(m["mi"], res["mi"][..., i])


class Boom(RuntimeError):
    pass


def test_chunked_resume_from_chunk_boundary_save(tmp_path):
    """Chunks of 2 over 7 frames with a save once 3 frames have run since the
    last (JAX's chunk rule): the state is saved at frame 4 (not at 3 or 6,
    the loop mode's rule); a kill in frame 5's progress resumes there."""
    runner, cfg, kw = FRAME_CASES["vae-frame"]
    cfg = DpConfig(**{**DP, "num_frames": 7})
    ref = runner(cfg, 1, device="cpu", runs=2, **kw)
    ckpt = tmp_path / "state.npz"

    def killer(i, m):
        if i == 5:
            raise Boom()

    with pytest.raises(Boom):
        runner(cfg, 1, device="cpu", runs=2, chunk_frames=2, checkpoint=ckpt, checkpoint_every=3,
               progress=killer, **kw)
    with np.load(ckpt) as d:
        assert int(d["frame"]) == 4
    n0 = vae_dp_frame_train.launches
    resumed = runner(cfg, 1, device="cpu", runs=2, chunk_frames=2, checkpoint=ckpt,
                     checkpoint_every=3, **kw)
    assert vae_dp_frame_train.launches == n0  # the plain version on the CPU: nothing launched
    _assert_same(resumed, ref, "resumed")


@pytest.mark.parametrize("name", ["vae-frame", "cmabatch-kernel-D", "vaele-kernel-F"])
def test_timings_keys_and_reset(name):
    runner, cfg, kw = {**FRAME_CASES, **EPOCH_CASES}[name]
    timings = {}
    got = runner(cfg, 2, device="cpu", runs=2, compiled=True, timings=timings, **kw)
    assert set(timings) == {"compile_s", "run_s"} and min(timings.values()) > 0
    _assert_same(got, runner(cfg, 2, device="cpu", runs=2, **kw), "timed")


def test_frame_experiments_timings_equal_plain_run():
    cfg = AwgnVaeLeConfig(**AWGN)
    for runner, c in ((train_vae_le_awgn, cfg), (train_vae_nn_awgn, AwgnVaeNnConfig(**NN))):
        timings = {}
        got = runner(c, 4, device="cpu", runs=2, use_pallas="frame", timings=timings)
        assert set(timings) == {"compile_s", "run_s"} and min(timings.values()) > 0
        _assert_same(got, runner(c, 4, device="cpu", runs=2, use_pallas="frame"), runner.__name__)


def test_sweep_passes_compiled_and_drops_progress(monkeypatch, tmp_path):
    seen = []
    real = sweep.RUNNERS["VAE"]

    @functools.wraps(real)  # the sweep reads the runner's parameters from its signature
    def runner(cfg, seed, **kw):
        seen.append({k: kw.get(k) for k in ("compiled", "progress")})
        return real(cfg, seed, **kw)

    monkeypatch.setitem(sweep.RUNNERS, "VAE", runner)
    cfg = DpConfig(**{**DP, "num_frames": 2})
    out, _, _ = run_sweep("VAE", cfg, {"lr": [1e-3]}, 2, 0, out_dir=tmp_path, device="cpu",
                          compiled=True, progress=lambda i, m: None, runner_kwargs={"use_pallas": "frame"})
    assert seen == [{"compiled": True, "progress": None}]
    loop, _, _ = run_sweep("VAE", cfg, {"lr": [1e-3]}, 2, 0, out_dir=tmp_path / "loop",
                           device="cpu", runner_kwargs={"use_pallas": "frame"})
    np.testing.assert_array_equal(out[0]["ser"], loop[0]["ser"])


def test_compiled_matches_jax_compiled_on_jax_draws():
    """``train_vae_dp(use_pallas=False, compiled=True)`` on the JAX package's
    draws against JAX's compiled run (its keys per frame are the loop
    mode's), within tests/test_torch_train_dp.py's chaos-aware tolerances."""
    small = dict(mod="4-QAM", num_frames=2, n_frame_max=200, batch_len=50, n_lrhalf=1)
    key = jax.random.PRNGKey(5)
    res_j = j_train_vae_dp(JDpConfig(**small), key, runs=RUNS, use_pallas=False, compiled=True)
    cfg = DpConfig(**small)
    sim = _setup(cfg, cfg.n_frame_max // cfg.batch_len * cfg.batch_len, "cpu")[2]
    draws = _jax_draws(cfg, key, sim)
    res = train_vae_dp(cfg, 0, device="cpu", runs=RUNS, use_pallas=False, compiled=True,
                       draws=lambda frame, r: draws[frame])
    assert res["ser"].shape == res_j["ser"].shape == (RUNS, 4, cfg.num_frames)
    np.testing.assert_allclose(res["ser"], res_j["ser"], atol=0.05)
    np.testing.assert_allclose(res["mi"], res_j["mi"], rtol=5e-2)
    np.testing.assert_allclose(res["var_est"], res_j["var_est"], rtol=5e-2)
    np.testing.assert_allclose(res["params"]["w"].numpy(), np.asarray(res_j["params"]["w"]), atol=0.05)


def _jax_compiled_awgn_draws(cfg, key, sims):
    """The draws of JAX's compiled epoch loop with runs (train/awgn.py:89-101):
    train keys split from the key, eval keys from fold_in(key, 0x5EED)."""
    const = sims["train"].const
    amps, P = jnp.asarray(const.amps), jnp.asarray(const.P, jnp.float32)

    def frame(k, kind):
        lev, noi = [], []
        for rkey in jax.random.split(k, RUNS):
            k_sym, k_noise = jax.random.split(rkey)
            lev.append(np.array(j_sample_levels(k_sym, amps, P, (2, sims[kind].n_conv))))
            noi.append(np.array(jax.random.normal(k_noise, (2, sims[kind].sig_len), jnp.float32)))
        return torch.from_numpy(np.stack(lev)), torch.from_numpy(np.stack(noi))

    n_evals = cfg.num_epochs // cfg.epe
    return {"train": [frame(k, "train") for k in jax.random.split(key, cfg.num_epochs)],
            "valid": [frame(k, "valid") for k in
                      jax.random.split(jax.random.fold_in(key, 0x5EED), n_evals)]}


def test_awgn_compiled_matches_jax_compiled_on_jax_draws():
    """``train_vae_le_awgn(use_pallas=True, compiled=True)`` against JAX's
    compiled superstep scan (epe divides the epochs: JAX's compiled mode
    drops a trailing partial block) within the loop-mode parity test's
    tolerances (tests/test_torch_train_awgn.py)."""
    small = dict(mod="16-QAM", snr_db=20.0, lr=2e-3, num_epochs=6, epe=3, n_train=256,
                 batch_len=128, n_valid=1500)
    rng = np.random.default_rng(0)
    w = np.zeros((1, 2, 25), np.float32)
    w[0, 0, 12] = 1.0
    h = np.zeros((2, 25), np.float32)
    h[0, 12] = 1.0
    p0 = {"w": w + 0.03 * rng.normal(size=w.shape).astype(np.float32),
          "h": h + 0.03 * rng.normal(size=h.shape).astype(np.float32)}
    key = jax.random.PRNGKey(7)
    res_j = j_train_vae_le_awgn(JAwgnVaeLeConfig(**small), key, runs=RUNS, compiled=True,
                                params_init={k: jnp.asarray(v) for k, v in p0.items()})
    cfg = AwgnVaeLeConfig(**small)
    draws = _jax_compiled_awgn_draws(cfg, key, train_awgn._setup(cfg, "cpu")[1])
    res = train_vae_le_awgn(cfg, 0, device="cpu", runs=RUNS, use_pallas=True, compiled=True,
                            draws=lambda kind, i, r: draws[kind][i], params_init=p0)
    assert res["ser"].shape == np.shape(res_j["ser"]) == (RUNS, 2)
    np.testing.assert_allclose(res["ser"], np.asarray(res_j["ser"]), rtol=0, atol=2 / cfg.n_valid)
    np.testing.assert_allclose(res["mi"], np.asarray(res_j["mi"]), rtol=0, atol=2e-3)
    p_j = siso_params_from_jax({k: np.asarray(v) for k, v in res_j["params"].items()})
    np.testing.assert_allclose(res["params"]["w"].numpy(), p_j["w"].numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(res["params"]["h"].numpy(), p_j["h"].numpy(), rtol=0, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the capture and replay run on the card")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["vae-frame", "cma-kernel-C", "cmaflex-kernel-D"])
def test_capture_replays_kernels_and_equals_loop_on_card(cuda, name):
    runner, cfg, kw = FRAME_CASES[name]
    ref = runner(cfg, 3, device="cuda", runs=2, **kw)
    kernel = {"vae-frame": "vae_dp_frame_train", "cma-kernel-C": "cma_dp_kernel",
              "cmaflex-kernel-D": "cma_chunked_frame"}[name]
    from vae_equalizer_tpu_torch import ops

    wrapper = getattr(ops, kernel)
    n0 = wrapper.launches
    got = runner(cfg, 3, device="cuda", runs=2, compiled=True, **kw)
    assert wrapper.launches - n0 == FRAMES  # one capture, replayed per frame
    _assert_same(got, ref, "compiled")
    _assert_same(runner(cfg, 3, device="cuda", runs=2, chunk_frames=2, **kw), ref, "chunked")
