"""Port parity for the slice as a whole: ``train_vae_dp(use_pallas="frame")``.

The JAX experiment runs with its frame kernel in interpret mode; the port's
experiment runs on the CPU (the kernels' plain versions) and is fed the very
channel draws the JAX simulator makes from its keys, through the ``draws``
seam. Also: weight conversion from the JAX package, and the port's
independence from JAX (every module imports without it).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_equalizer_tpu.core.constellation import sample_levels as j_sample_levels
from vae_equalizer_tpu.train.dp import train_vae_dp as j_train_vae_dp
from vae_equalizer_tpu.utils.config import DpConfig as JDpConfig
from vae_equalizer_tpu_torch.core import make_constellation
from vae_equalizer_tpu_torch.train.dp import _setup, train_vae_dp
from vae_equalizer_tpu_torch.utils import DpConfig
from vae_equalizer_tpu_torch.utils.convert import opt_from_jax, params_from_jax

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RUNS = 2
SMALL = dict(num_frames=2, n_frame_max=200, batch_len=50, n_lrhalf=1)  # w lr halves at frame 2


def _interpret_frame_kernel(monkeypatch):
    import vae_equalizer_tpu.ops.frame_kernel as fk

    orig = fk.vae_dp_frame_train_pallas_rb
    monkeypatch.setattr(fk, "vae_dp_frame_train_pallas_rb",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _jax_draws(cfg, key, sim):
    """The per-frame, per-run draws of JAX's runs path (train/dp.py:450-454,
    optical_dp.py:140-177), as numpy."""
    const = make_constellation(cfg.mod, cfg.nu)
    amps, P = jnp.asarray(const.amps), jnp.asarray(const.P, jnp.float32)
    out = []
    for fkey in jax.random.split(key, cfg.num_frames):
        lev, noi = [], []
        for rkey in jax.random.split(fkey, RUNS):
            k_sym, k_noise = jax.random.split(rkey)
            lev.append(np.array(j_sample_levels(k_sym, amps, P, (4, sim.n_conv))))
            noi.append(np.array(jax.random.normal(k_noise, (2, 2, sim.sig_len), jnp.float32)))
        out.append((torch.from_numpy(np.stack(lev)), torch.from_numpy(np.stack(noi))))
    return out


@pytest.mark.parametrize("mod", ["4-QAM", "64-QAM"])
def test_train_vae_dp_matches_jax_on_jax_draws(monkeypatch, mod):
    _interpret_frame_kernel(monkeypatch)
    key = jax.random.PRNGKey(5)
    res_j = j_train_vae_dp(JDpConfig(mod=mod, **SMALL), key, runs=RUNS, use_pallas="frame")

    cfg = DpConfig(mod=mod, **SMALL)
    m_max = cfg.n_frame_max // cfg.batch_len
    sim = _setup(cfg, m_max * cfg.batch_len, "cpu")[2]
    draws = _jax_draws(cfg, key, sim)
    res = train_vae_dp(cfg, 0, device="cpu", runs=RUNS, use_pallas="frame",
                       draws=lambda frame, r: draws[frame])

    assert res["ser"].shape == res_j["ser"].shape == (RUNS, 4, cfg.num_frames)
    assert res["mi"].shape == res_j["mi"].shape and res["var_est"].shape == res_j["var_est"].shape
    np.testing.assert_array_equal(res["var"], np.asarray(res_j["var"]))
    assert np.all(np.isfinite(res["ser"])) and np.all(np.isfinite(res["mi"]))
    # chaos-aware tolerances (as tests/test_frame_kernel.py:169-179): the two
    # packages round the step's reductions in different orders, and this
    # aggressive-lr toy amplifies ~1e-7 per-step differences ~30x per Adam
    # step, so only coarse equality holds; a layout or sign bug is O(1)
    np.testing.assert_allclose(res["ser"], res_j["ser"], atol=0.05)
    np.testing.assert_allclose(res["mi"], res_j["mi"], rtol=5e-2)
    np.testing.assert_allclose(res["var_est"], res_j["var_est"], rtol=5e-2)
    np.testing.assert_allclose(res["params"]["w"].numpy(), np.asarray(res_j["params"]["w"]), atol=0.05)

    # the JAX experiment's trained weights carry over to the port
    p = params_from_jax({k: np.asarray(v) for k, v in res_j["params"].items()})
    np.testing.assert_array_equal(p["w"].numpy(), np.asarray(res_j["params"]["w"]))
    np.testing.assert_array_equal(p["h"].numpy(), np.asarray(res_j["params"]["h"]))


def test_weight_conversion_checks_shapes():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 2, 4, 25)).astype(np.float32)
    h = rng.normal(size=(3, 2, 2, 2, 25)).astype(np.float32)
    p = params_from_jax({"w": w, "h": h})
    assert p["w"].dtype == torch.float32 and p["w"].device.type == "cpu"
    np.testing.assert_array_equal(p["w"].numpy(), w)
    opt = opt_from_jax({"mw": w, "vw": w, "mh": h, "vh": h})
    np.testing.assert_array_equal(opt["vh"].numpy(), h)
    with pytest.raises(ValueError):
        params_from_jax({"w": w, "h": h[..., :24]})
    with pytest.raises(ValueError):
        params_from_jax({"w": w, "h": h[:2]})
    with pytest.raises(TypeError):
        params_from_jax({"w": w.astype(np.float64), "h": h})


def test_deferred_options_raise():
    cfg = DpConfig(mod="4-QAM", **SMALL)
    for kw in ({"stream_bf16": True}, {"lr_vec": [1e-3]}, {"compiled": True}, {"chunk_frames": 2},
               {"checkpoint": "x.npz"}, {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            train_vae_dp(cfg, 0, device="cpu", **kw)


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import vae_equalizer_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax',"
        " 'vae_equalizer_tpu'))\n"
        "assert len(names) >= 20, names\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
