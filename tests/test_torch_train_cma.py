"""Port parity for the CMA baselines as a whole: ``run_cma_dp``.

The JAX experiment runs its plain scan engines; the port runs on the CPU in
its plain mode and in its kernel mode (whose wrapper takes the plain
version on the CPU), fed the very channel draws the JAX simulator makes
from its keys, through the ``draws`` seam. Frame for frame: shift and pol
assignment equal, taps rtol 1e-4 / atol 1e-6, MI rtol 1e-4, SER within
2e-3 (~4 of the ~2000 evaluated symbols: a float32 summation-order
difference may move a symbol across a decision boundary). Also: the mode
table, the zero ``var_est`` of the result, taps from the JAX package, and
the deferred options.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_equalizer_tpu.core.constellation import sample_levels as j_sample_levels
from vae_equalizer_tpu.train.dp import run_cma_dp as j_run_cma_dp
from vae_equalizer_tpu.train.modes import PALLAS_MODES as J_PALLAS_MODES
from vae_equalizer_tpu.utils.config import DpConfig as JDpConfig
from vae_equalizer_tpu_torch.core import make_constellation
from vae_equalizer_tpu_torch.ops import cma_chunked_frame, cma_dp_kernel
from vae_equalizer_tpu_torch.train import run_cma_dp, train_vae_dp
from vae_equalizer_tpu_torch.train.dp import _setup
from vae_equalizer_tpu_torch.train.modes import PALLAS_MODES
from vae_equalizer_tpu_torch.utils import DpConfig
from vae_equalizer_tpu_torch.utils.convert import taps_from_jax

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RUNS = 2
SMALL = dict(mod="4-QAM", snr_db=20.0, num_frames=3, n_frame_max=2000, batch_len=100, flex_step=10,
             n_lrhalf=2)  # the lr halves for frame 3
VARIANTS = [("CMA", 1e-3, True), ("CMAbatch", 1e-4, "frame"), ("CMAflex", 5e-5, "frame")]


def _jax_draws(cfg, key, sim, runs):
    """Per-frame draws of JAX's run_cma_dp (one key per run split from the
    frame key when ``runs`` is set), as numpy-made torch tensors."""
    const = make_constellation(cfg.mod, cfg.nu)
    amps, P = jnp.asarray(const.amps), jnp.asarray(const.P, jnp.float32)
    out = []
    for fkey in jax.random.split(key, cfg.num_frames):
        lev, noi = [], []
        for rkey in (jax.random.split(fkey, runs) if runs else [fkey]):
            k_sym, k_noise = jax.random.split(rkey)
            lev.append(np.array(j_sample_levels(k_sym, amps, P, (4, sim.n_conv))))
            noi.append(np.array(jax.random.normal(k_noise, (2, 2, sim.sig_len), jnp.float32)))
        out.append((torch.from_numpy(np.stack(lev)), torch.from_numpy(np.stack(noi))))
    return out


def _per_frame(store):
    return lambda frame, m: store.append({k: np.array(v) for k, v in m.items()})


@pytest.mark.parametrize("variant,lr,kernel_mode", VARIANTS)
def test_run_cma_dp_matches_jax_on_jax_draws(variant, lr, kernel_mode):
    key = jax.random.PRNGKey(5)
    m_j = []
    res_j = j_run_cma_dp(JDpConfig(loss_type=variant, lr=lr, **SMALL), key, runs=RUNS,
                         progress=_per_frame(m_j))
    cfg = DpConfig(loss_type=variant, lr=lr, **SMALL)
    draws = _jax_draws(cfg, key, _setup(cfg, cfg.n_frame_max, "cpu")[2], RUNS)
    for mode in (False, kernel_mode):
        m_t = []
        res = run_cma_dp(cfg, 0, device="cpu", runs=RUNS, use_pallas=mode, draws=lambda f, r: draws[f],
                         progress=_per_frame(m_t))
        assert res["ser"].shape == res_j["ser"].shape == (RUNS, 4, cfg.num_frames)
        assert res["mi"].shape == (RUNS, 2, cfg.num_frames) and res["taps"].shape == (RUNS, 2, 2, 2, 25)
        np.testing.assert_array_equal(res["var_est"], np.zeros((RUNS, 2, cfg.num_frames), np.float32))
        np.testing.assert_array_equal(res["var_est"], np.asarray(res_j["var_est"]))
        np.testing.assert_array_equal(res["var"], np.asarray(res_j["var"]))
        for f in range(cfg.num_frames):
            np.testing.assert_array_equal(m_t[f]["shift"], m_j[f]["shift"])
            np.testing.assert_array_equal(m_t[f]["r"], m_j[f]["r"])
            np.testing.assert_allclose(m_t[f]["loss"], m_j[f]["loss"], rtol=1e-4)
        np.testing.assert_allclose(res["ser"], res_j["ser"], atol=2e-3)
        np.testing.assert_allclose(res["mi"], res_j["mi"], rtol=1e-4)
        np.testing.assert_allclose(res["taps"].numpy(), np.asarray(res_j["taps"]), rtol=1e-4, atol=1e-6)
    # an adapted equalizer: the last frame's constellation SER is low
    assert np.all(res["ser"][:, :2, -1] < 0.05)


def test_single_run_and_taps_from_jax():
    """runs=None (no runs axis, draws from the frame key) seeded with the
    JAX experiment's adapted taps, given as a numpy array."""
    cfg_j = JDpConfig(loss_type="CMAbatch", lr=1e-4, **SMALL)
    key = jax.random.PRNGKey(8)
    taps_j = j_run_cma_dp(cfg_j, jax.random.PRNGKey(3))["taps"]
    taps = taps_from_jax(np.asarray(taps_j))
    np.testing.assert_array_equal(taps.numpy(), np.asarray(taps_j))
    res_j = j_run_cma_dp(cfg_j, key, taps_init=taps_j)
    cfg = DpConfig(loss_type="CMAbatch", lr=1e-4, **SMALL)
    draws = _jax_draws(cfg, key, _setup(cfg, cfg.n_frame_max, "cpu")[2], None)
    res = run_cma_dp(cfg, 0, device="cpu", use_pallas="frame", taps_init=np.asarray(taps_j),
                     draws=lambda f, r: draws[f])
    assert res["ser"].shape == (4, cfg.num_frames) and res["var_est"].shape == (2, cfg.num_frames)
    assert res["taps"].shape == (2, 2, 2, 25)
    np.testing.assert_allclose(res["ser"], res_j["ser"], atol=2e-3)
    np.testing.assert_allclose(res["taps"].numpy(), np.asarray(res_j["taps"]), rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError):
        taps_from_jax(np.asarray(taps_j)[:1])
    with pytest.raises(TypeError):
        taps_from_jax(np.asarray(taps_j).astype(np.float64))


def _tiny(loss_type):
    return DpConfig(loss_type=loss_type, mod="4-QAM", snr_db=20.0, num_frames=2, n_frame_max=600,
                    batch_len=100, flex_step=10, m_est=5, n_lrhalf=170, lr=1e-4)


@pytest.mark.parametrize("mode", [False, True, "frame"], ids=str)
@pytest.mark.parametrize("loss_type", ["CMA", "CMAbatch", "CMAflex"])
def test_every_mode_runs_or_raises(loss_type, mode):
    """The port's table is the JAX table; a mode outside it raises the JAX
    ValueError, a mode in it runs (here in groups of runs_batch)."""
    assert PALLAS_MODES == J_PALLAS_MODES
    cfg = _tiny(loss_type)
    if mode in PALLAS_MODES[loss_type]:
        res = run_cma_dp(cfg, 0, device="cpu", runs=4, runs_batch=2, use_pallas=mode)
        assert res["ser"].shape == (4, 4, cfg.num_frames) and np.all(np.isfinite(res["mi"]))
    else:
        with pytest.raises(ValueError, match="use_pallas"):
            run_cma_dp(cfg, 0, device="cpu", use_pallas=mode)


def test_vae_modes_follow_the_table():
    """train_vae_dp: a mode outside the table raises the JAX ValueError; every
    mode in the table (False, True, "frame") runs."""
    cfg = DpConfig(mod="4-QAM", num_frames=1, n_frame_max=200, batch_len=50)
    with pytest.raises(ValueError, match="use_pallas"):
        train_vae_dp(cfg, 0, device="cpu", use_pallas="bogus")
    for mode in (False, True, "frame"):
        res = train_vae_dp(cfg, 0, device="cpu", use_pallas=mode)
        assert res["ser"].shape == (4, 1) and np.all(np.isfinite(res["ser"]))


def test_deferred_options_and_bad_arguments_raise():
    cfg = _tiny("CMAbatch")
    for kw in ({"mesh": object()}, {"compiled": True}, {"chunk_frames": 2},
               {"checkpoint": "x.npz"}, {"timings": {}}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            run_cma_dp(cfg, 0, device="cpu", **kw)
    with pytest.raises(ValueError, match="runs_batch"):
        run_cma_dp(cfg, 0, device="cpu", runs=4, runs_batch=3, use_pallas="frame")
    with pytest.raises(ValueError, match="CMA variant"):
        run_cma_dp(_tiny("VAE"), 0, device="cpu")
    with pytest.raises(ValueError, match="unknown loss_type"):
        run_cma_dp(_tiny("nope"), 0, device="cpu")
    # off the card no kernel launches: the wrappers took their plain versions
    assert cma_dp_kernel.launches == 0 and cma_chunked_frame.launches == 0
