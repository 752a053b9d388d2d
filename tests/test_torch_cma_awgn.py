"""Port parity: the AWGN CMA experiment (``train/awgn.py: run_cma_awgn``) and
its parts, against the reference fixtures and the JAX package on the CPU.

* ``cma_siso`` / ``cpe_siso`` / ``ser_const_siso`` / ``ser_symb_siso``
  against cma_awgn.npz, cpe_awgn.npz, ser_siso.npz (``ser_cma``) and
  ser_symb.npz at the JAX package's tolerances (tests/test_cma.py,
  tests/test_metrics.py);
* the same functions and ``find_shift_symb_siso`` against the JAX functions
  on shared numpy inputs (float32 sums in another order: outputs at rtol
  1e-4; shifts, decisions and SERs equal);
* kernel I's plain engine (``ops/cma_siso_kernel.py``) equal to the
  per-epoch ``cma_siso`` loop, and within rounding of JAX's per-epoch
  ``cma_siso``;
* ``run_cma_awgn`` (4-QAM, 6 epochs, runs 2) eval for eval against JAX's
  loop on JAX's draws (fed through ``draws``);
* kernel I against its plain version on the card (``requires_cuda``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_run_sharding import check_mesh_argument
from vae_equalizer_tpu.core.constellation import sample_levels as j_sample_levels
from vae_equalizer_tpu.metrics import cpe_siso as j_cpe_siso
from vae_equalizer_tpu.metrics import find_shift_symb_siso as j_find_shift_symb_siso
from vae_equalizer_tpu.metrics import ser_const_siso as j_ser_const_siso
from vae_equalizer_tpu.metrics.ser import ser_symb_siso as j_ser_symb_siso
from vae_equalizer_tpu.models import cma_siso as j_cma_siso
from vae_equalizer_tpu.train.awgn import run_cma_awgn as j_run_cma_awgn
from vae_equalizer_tpu.utils.config import AwgnCmaConfig as JAwgnCmaConfig
from vae_equalizer_tpu_torch.core import make_constellation
from vae_equalizer_tpu_torch.metrics import cpe_siso, find_shift_symb_siso, ser_const_siso, ser_symb_siso
from vae_equalizer_tpu_torch.models import cma_siso, dirac_taps_siso
from vae_equalizer_tpu_torch.ops.cma_siso_kernel import (
    cma_siso_experiment,
    cma_siso_experiment_plain,
)
from vae_equalizer_tpu_torch.train.awgn import _setup, run_cma_awgn
from vae_equalizer_tpu_torch.utils import AwgnCmaConfig

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

T = torch.from_numpy


# ---------------------------------------------------------------- fixtures


def test_cma_siso_golden(golden):
    g = golden("cma_awgn")
    out, h, e = cma_siso(T(g["Rx"]), 1.0, T(g["h0"]), float(g["lr"]), 2, True)
    np.testing.assert_allclose(out.numpy(), g["out"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(h.numpy(), g["h"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(e.numpy(), g["e"], rtol=1e-3, atol=1e-5)


def test_cpe_siso_golden(golden):
    g = golden("cpe_awgn")
    np.testing.assert_allclose(cpe_siso(T(g["y"])).numpy(), g["y_corr"], rtol=2e-4, atol=2e-5)


def test_ser_siso_goldens(golden):
    g = golden("ser_siso")
    got = ser_const_siso(T(g["rx"]), T(g["tx"]), T(g["amp_levels"]))
    np.testing.assert_allclose(float(got), g["ser_cma"], atol=1e-6)
    g = golden("ser_symb")
    got = ser_symb_siso(T(g["rx"]), T(g["tx"]), T(g["amps"]), 2)
    np.testing.assert_allclose(float(got), g["ser"], atol=1e-6)


# ---------------------------------------------------------------- against JAX


def _signal(seed, mod="16-QAM", n=3000, sps=2, shift=3, noise=0.05):
    """Equalizer-like output: tx levels delayed by ``shift`` symbols, a phase
    rotation and noise; rx at sps samples per symbol (numpy seed)."""
    rng = np.random.default_rng(seed)
    amps = make_constellation(mod).amps
    tx = amps[rng.integers(0, amps.shape[0], size=(2, n))].astype(np.float32)
    sym = np.roll(tx, shift, axis=-1)
    c, s = np.cos(0.3), np.sin(0.3)
    out = np.stack([c * sym[0] - s * sym[1], s * sym[0] + c * sym[1]])
    out = (out + noise * rng.normal(size=out.shape)).astype(np.float32)
    rx = np.repeat(out, sps, axis=-1) + (0.1 * rng.normal(size=(2, n * sps))).astype(np.float32)
    return amps.astype(np.float32), tx, out, rx.astype(np.float32)


@pytest.mark.parametrize("update", [True, False])
def test_cma_siso_matches_jax_with_runs_axis(update):
    rng = np.random.default_rng(3)
    rx = (0.7 * rng.normal(size=(3, 2, 1200))).astype(np.float32)
    h0 = (np.asarray(dirac_taps_siso(25)) + 0.02 * rng.normal(size=(3, 2, 25))).astype(np.float32)
    got = cma_siso(T(rx), 1.0, T(h0), 2e-3, 2, update)
    for r in range(3):
        want = j_cma_siso(jnp.asarray(rx[r]), 1.0, jnp.asarray(h0[r]), 2e-3, 2, update)
        for name, a, b in zip(("out", "h", "e"), got, want):
            np.testing.assert_allclose(a[r].numpy(), np.asarray(b), rtol=1e-4, atol=1e-5,
                                       err_msg=name)


def test_siso_metrics_match_jax():
    amps, tx, out, rx = _signal(5)
    w = np.ones(tx.shape[-1], np.float32)
    w[:40] = 0
    got_cpe, want_cpe = cpe_siso(T(out)).numpy(), np.asarray(j_cpe_siso(jnp.asarray(out)))
    np.testing.assert_allclose(got_cpe, want_cpe, rtol=1e-4, atol=1e-5)
    for n_shift in (21, 24):
        assert int(find_shift_symb_siso(T(out), T(tx), n_shift)) == int(
            j_find_shift_symb_siso(jnp.asarray(out), jnp.asarray(tx), n_shift)) == 3
    for weight in (None, w):
        kw_t = {} if weight is None else {"weight": T(weight)}
        kw_j = {} if weight is None else {"weight": jnp.asarray(weight)}
        for sig in (out, got_cpe, np.roll(got_cpe, -3, axis=-1)):
            assert float(ser_const_siso(T(sig), T(tx), T(amps), **kw_t)) == pytest.approx(
                float(j_ser_const_siso(jnp.asarray(sig), jnp.asarray(tx), jnp.asarray(amps), **kw_j)),
                abs=1e-6)
        assert float(ser_symb_siso(T(rx), T(tx), T(amps), 2, **kw_t)) == pytest.approx(
            float(j_ser_symb_siso(jnp.asarray(rx), jnp.asarray(tx), jnp.asarray(amps), 2, **kw_j)),
            abs=1e-6)
    # batched over a runs axis: each row as alone
    batch = np.stack([out, np.roll(out, 2, axis=-1)])
    shifts = find_shift_symb_siso(T(batch), T(np.stack([tx, tx])), 21)
    assert shifts.tolist() == [3, 5]
    sers = ser_const_siso(T(batch), T(np.stack([tx, tx])), T(amps))
    assert sers.shape == (2,) and float(sers[0]) == float(ser_const_siso(T(out), T(tx), T(amps)))


def test_kernel_i_plain_engine_is_the_per_epoch_loop():
    """cma_siso_experiment on CPU tensors equals cma_siso once per epoch (the
    port's, bit for bit; JAX's within rounding), with eval slot i the taps
    after epoch i*epe and the loss each epoch's mean |e|."""
    rng = np.random.default_rng(8)
    R, E, n, epe = 2, 5, 400, 2
    rx = T((0.7 * rng.normal(size=(R, E, 2, 2 * n))).astype(np.float32))
    h0 = (dirac_taps_siso(25) + T((0.01 * rng.normal(size=(R, 2, 25))).astype(np.float32)))
    h, h_ev, loss = cma_siso_experiment(rx, h0, 1.0, 1e-3, 2, epe)
    assert h.shape == (R, 2, 25) and h_ev.shape == (E // epe, R, 2, 25) and loss.shape == (R, E)
    h_p, h_j = h0, [jnp.asarray(h0[r].numpy()) for r in range(R)]
    for ep in range(E):
        _, h_p, e = cma_siso(rx[:, ep], 1.0, h_p, 1e-3, 2)
        assert torch.equal(loss[:, ep], e.abs().mean(-1))
        if ep % epe == 0 and ep // epe < E // epe:  # epoch 4 trains without a slot
            assert torch.equal(h_ev[ep // epe], h_p)
        for r in range(R):
            _, h_j[r], e_j = j_cma_siso(jnp.asarray(rx[r, ep].numpy()), 1.0, h_j[r], 1e-3, 2, True)
            np.testing.assert_allclose(float(loss[r, ep]), float(jnp.mean(jnp.abs(e_j))), rtol=1e-5)
    assert torch.equal(h, h_p)
    np.testing.assert_allclose(h.numpy(), np.stack([np.asarray(x) for x in h_j]), rtol=0, atol=1e-5)
    # the plain version is what the CPU dispatch takes
    for a, b in zip(cma_siso_experiment_plain(rx, h0, 1.0, 1e-3, 2, epe), (h, h_ev, loss)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- the runner

RUNS = 2
SMALL = dict(mod="4-QAM", snr_db=12.0, lr=1e-3, num_epochs=6, epe=2, n_train=1000, n_valid=2000)


def _jax_loop_draws(cfg, key, sims):
    """The per-epoch / per-eval, per-run draws of JAX's loop mode with runs
    (train/awgn.py:137-148, channels/awgn.py:79-95)."""
    const = sims["train"].const
    amps, P = jnp.asarray(const.amps), jnp.asarray(const.P, jnp.float32)

    def frame(k, kind):
        lev, noi = [], []
        for rkey in jax.random.split(k, RUNS):
            k_sym, k_noise = jax.random.split(rkey)
            lev.append(np.array(j_sample_levels(k_sym, amps, P, (2, sims[kind].n_conv))))
            noi.append(np.array(jax.random.normal(k_noise, (2, sims[kind].sig_len), jnp.float32)))
        return T(np.stack(lev)), T(np.stack(noi))

    out = {"train": [], "valid": []}
    n_evals = cfg.num_epochs // cfg.epe
    for epoch in range(cfg.num_epochs):
        key, k1 = jax.random.split(key)
        out["train"].append(frame(k1, "train"))
        if epoch % cfg.epe == 0 and epoch // cfg.epe < n_evals:
            key, k2 = jax.random.split(key)
            out["valid"].append(frame(k2, "valid"))
    return out


def test_run_cma_awgn_matches_jax_on_jax_draws():
    key = jax.random.PRNGKey(7)
    prog_j, prog_t = [], []
    res_j = j_run_cma_awgn(JAwgnCmaConfig(**SMALL), key, runs=RUNS,
                           progress=lambda e, m: prog_j.append((e, m)))
    cfg = AwgnCmaConfig(**SMALL)
    draws = _jax_loop_draws(cfg, key, _setup(cfg, "cpu")[1])
    res = run_cma_awgn(cfg, 0, device="cpu", runs=RUNS, draws=lambda k, i, R: draws[k][i],
                       progress=lambda e, m: prog_t.append((e, m)))
    n_evals = cfg.num_epochs // cfg.epe
    assert res["ser"].shape == np.asarray(res_j["ser"]).shape == (RUNS, n_evals)
    assert res["mi"].shape == (RUNS, n_evals) and tuple(res["taps"].shape) == (RUNS, 2, 25)
    assert 0 < res["ser"][:, 0].min() and np.all(res["ser"][:, -1] < res["ser"][:, 0])
    # 6,000 dependent LMS updates in another rounding order leave the taps
    # ~1e-6 apart: a decision or two
    np.testing.assert_allclose(res["ser"], np.asarray(res_j["ser"]), rtol=0, atol=2 / cfg.n_valid)
    np.testing.assert_allclose(res["mi"], np.asarray(res_j["mi"]), rtol=0, atol=2e-3)
    np.testing.assert_allclose(res["taps"].numpy(), np.asarray(res_j["taps"]), rtol=0, atol=1e-4)
    assert [e for e, _ in prog_t] == [e for e, _ in prog_j] == [0, 2, 4]
    for (_, mt), (_, mj) in zip(prog_t, prog_j):
        np.testing.assert_allclose(mt["loss"], np.asarray(mj["loss"]), rtol=1e-4)
        np.testing.assert_array_equal(mt["shift"], np.asarray(mj["shift"]))


def test_run_cma_awgn_single_run_and_options():
    cfg = AwgnCmaConfig(**{**SMALL, "num_epochs": 5})  # epe 2: evals after epochs 0 and 2
    res = run_cma_awgn(cfg, 4, device="cpu")
    assert res["ser"].shape == res["mi"].shape == (2,) and tuple(res["taps"].shape) == (2, 25)
    assert np.all(np.isfinite(res["ser"])) and np.all(np.isfinite(res["mi"]))
    check_mesh_argument(lambda mesh: run_cma_awgn(cfg, 0, device="cpu", runs=2, mesh=mesh))
    timings = {}  # compiled / timings: the one-launch experiment, bit for bit
    got = run_cma_awgn(cfg, 4, device="cpu", compiled=True, timings=timings)
    np.testing.assert_array_equal(got["ser"], res["ser"])
    np.testing.assert_array_equal(got["mi"], res["mi"])
    assert torch.equal(got["taps"], res["taps"]) and set(timings) == {"compile_s", "run_s"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ for sm_90a)")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("m,sps,R", [(25, 2, 3), (41, 2, 3), (64, 2, 3), (9, 1, 5), (25, 2, 200)],
                         ids=["m25", "m41", "m64", "m9_sps1", "m25_R200"])
def test_kernel_i_matches_plain_on_card(cuda, m, sps, R):
    """Kernel I's lane groups: 1, 4 and 8 taps a lane, sps 1, and 200 runs
    (more than the card's SMs: two runs share a warp)."""
    rng = np.random.default_rng(m)
    rx = T((0.7 * rng.normal(size=(R, 3, 2, 2000))).astype(np.float32)).to(cuda)
    h0 = (dirac_taps_siso(m) + T((0.01 * rng.normal(size=(R, 2, m))).astype(np.float32))).to(cuda)
    n0 = cma_siso_experiment.launches
    got = cma_siso_experiment(rx, h0, 1.0, 1e-3, sps, 1)
    again = cma_siso_experiment(rx, h0, 1.0, 1e-3, sps, 1)
    torch.cuda.synchronize()
    assert cma_siso_experiment.launches == n0 + 2
    want = cma_siso_experiment_plain(rx, h0, 1.0, 1e-3, sps, 1)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.cpu().numpy(), c.cpu().numpy(), rtol=1e-4,
                                   atol=1e-6 * float(c.abs().max()))
