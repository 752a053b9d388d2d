"""Port parity: the SISO VAE-LE model, ELBO and evaluation.

``vae_le_siso_forward`` (also runs-batched and at sps != 2), ``elbo_siso``
(shaped and uniform), ``ser_q_siso``, ``find_shift_siso``, ``roll_time`` /
``margin_weight`` and the packed eval against the reference fixtures and the
JAX package on identical numpy-seeded inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_equalizer_tpu.metrics import find_shift_siso as j_find_shift_siso
from vae_equalizer_tpu.metrics import ser_q_siso as j_ser_q_siso
from vae_equalizer_tpu.metrics.ser import _phase_variants as j_phase_variants
from vae_equalizer_tpu.models import vae_le_siso_forward as j_forward
from vae_equalizer_tpu.models import vae_le_siso_forward_runs as j_forward_runs
from vae_equalizer_tpu.models.losses import elbo_siso as j_elbo_siso
from vae_equalizer_tpu.train.awgn import _siso_eval_pack as j_eval_pack
from vae_equalizer_tpu.train.eval_utils import margin_weight as j_margin_weight
from vae_equalizer_tpu.train.eval_utils import roll_time as j_roll_time
from vae_equalizer_tpu_torch.core import make_constellation
from vae_equalizer_tpu_torch.metrics import find_shift_siso, ser_q_siso
from vae_equalizer_tpu_torch.metrics.ser import _phase_variants
from vae_equalizer_tpu_torch.models import (
    dirac_taps_siso,
    elbo_siso,
    siso_fir_init,
    vae_le_siso_forward,
)
from vae_equalizer_tpu_torch.train.awgn import _siso_eval_pack
from vae_equalizer_tpu_torch.train.eval_utils import margin_weight, roll_time

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

T = torch.from_numpy


def _taps(rng, R, M):
    w = np.zeros((R, 1, 2, M), np.float32)
    w[:, 0, 0, M // 2] = 1.0
    return w + 0.05 * rng.normal(size=w.shape).astype(np.float32)


def test_init_taps():
    w, h = siso_fir_init(25), dirac_taps_siso(25)
    assert w.shape == (1, 2, 25) and float(w[0, 0, 12]) == 1.0 and float(w.abs().sum()) == 1.0
    assert h.shape == (2, 25) and float(h[0, 12]) == 1.0 and float(h.abs().sum()) == 1.0


def test_siso_forward_golden(golden):
    g = golden("twofir")
    q, out = vae_le_siso_forward(T(g["w"]), T(g["x"]), T(g["amp_levels"]), float(g["amp_mean"]),
                                 float(g["var"]), 2)
    # the JAX test's tolerances (tests/test_vae_le.py:57-58)
    np.testing.assert_allclose(out.numpy(), g["out"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(q.numpy(), g["q_est"], rtol=1e-3, atol=1e-6)


def test_siso_forward_runs_matches_jax():
    """A runs axis with per-run taps == JAX's runs-batched form and per-run calls."""
    const = make_constellation("64-QAM", 0.0)
    rng = np.random.default_rng(3)
    R, M, L = 3, 25, 256
    w, x = _taps(rng, R, M), rng.normal(size=(R, 2, L)).astype(np.float32)
    amps, var = const.amps, 10 ** (-24 / 10)
    q, out = vae_le_siso_forward(T(w), T(x), T(amps), const.amp_mean, var, 2)
    q_j, out_j = j_forward_runs(jnp.asarray(w), jnp.asarray(x), jnp.asarray(amps), const.amp_mean, var, 2)
    assert q.shape == (R, 16, L // 2) and out.shape == (R, 2, L // 2)
    # float32 sums in another order; q through the 1/var = 251 softmin gain
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), rtol=1e-3, atol=1e-5)
    for r in range(R):
        q_r, _ = j_forward(jnp.asarray(w[r]), jnp.asarray(x[r]), jnp.asarray(amps), const.amp_mean, var, 2)
        np.testing.assert_allclose(q[r].numpy(), np.asarray(q_r), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("sps,M", [(1, 25), (3, 25), (2, 24)])
def test_siso_forward_any_sps_and_m(sps, M):
    """No sps-2 / odd-M restriction on the plain forward (ROADMAP queue 1 item 11)."""
    const = make_constellation("16-QAM", 0.0)
    rng = np.random.default_rng(sps + M)
    w, x = _taps(rng, 2, M), rng.normal(size=(2, 2, 150)).astype(np.float32)
    q, out = vae_le_siso_forward(T(w), T(x), T(const.amps), const.amp_mean, 0.02, sps)
    for r in range(2):
        q_j, out_j = j_forward(jnp.asarray(w[r]), jnp.asarray(x[r]), jnp.asarray(const.amps),
                               const.amp_mean, 0.02, sps)
        assert q[r].shape == q_j.shape and out[r].shape == out_j.shape
        np.testing.assert_allclose(out[r].numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(q[r].numpy(), np.asarray(q_j), rtol=1e-3, atol=1e-5)


def test_elbo_siso_golden(golden):
    g = golden("elbo_siso")
    args = (T(g["q"]), T(g["rx"]), T(g["h_est"]), T(g["amp_levels"]))
    # the JAX test's tolerance (tests/test_vae_le.py:96-97)
    np.testing.assert_allclose(float(elbo_siso(*args, T(g["P"]))), g["loss_shaped"], rtol=1e-5)
    np.testing.assert_allclose(float(elbo_siso(*args, None)), g["loss_uniform"], rtol=1e-5)


def test_elbo_siso_runs_axis_matches_jax():
    g = np.load(__import__("pathlib").Path(__file__).parent / "golden" / "elbo_siso.npz")
    rng = np.random.default_rng(9)
    h = (g["h_est"][None] + 0.05 * rng.normal(size=(2,) + g["h_est"].shape)).astype(np.float32)
    rx = (g["rx"][None] + 0.1 * rng.normal(size=(2,) + g["rx"].shape)).astype(np.float32)
    for P in (g["P"], None):
        loss = elbo_siso(T(g["q"]).expand(2, -1, -1), T(rx), T(h), T(g["amp_levels"]),
                         None if P is None else T(P))
        assert loss.shape == (2,)
        for r in range(2):
            want = j_elbo_siso(jnp.asarray(g["q"]), jnp.asarray(rx[r]), jnp.asarray(h[r]),
                               jnp.asarray(g["amp_levels"]), None if P is None else jnp.asarray(P))
            np.testing.assert_allclose(float(loss[r]), float(want), rtol=1e-5)


def test_ser_q_siso_golden(golden):
    g = golden("ser_siso")
    got = ser_q_siso(T(g["q"]), T(g["tx"]), g["amp_levels"].shape[0])
    np.testing.assert_allclose(float(got), g["ser_q"], atol=1e-6)


def test_phase_variants_and_weighted_ser_match_jax(golden):
    g = golden("ser_siso")
    dec = np.random.default_rng(2).integers(0, 8, size=(2, 40)).astype(np.int32)
    np.testing.assert_array_equal(_phase_variants(T(dec).long(), 8).numpy(),
                                  np.asarray(j_phase_variants(jnp.asarray(dec), 8, 0)))
    w = np.zeros(g["q"].shape[-1], np.float32)
    w[30:-50] = 1.0
    got = ser_q_siso(T(g["q"]), T(g["tx"]), 8, weight=T(w))
    want = j_ser_q_siso(jnp.asarray(g["q"]), jnp.asarray(g["tx"]), 8, weight=jnp.asarray(w))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)


def _synced_posteriors(rng, const, n, shifts, weak_i=()):
    """q (R, 2n, n) whose E_q[x^I] is tx_I rolled by each shift; runs in
    weak_i carry tx_Q in their I posteriors (a pi/2-rotated output: sync must
    fall back to the Q correlation)."""
    amps = const.amps
    idx = rng.integers(0, amps.shape[0], size=(len(shifts), 2, n))
    tx = amps[idx].astype(np.float32)
    q = np.full((len(shifts), 2 * amps.shape[0], n), 1e-3, np.float32)
    for r, s in enumerate(shifts):
        src = np.roll(idx, s, axis=-1)[r]
        q[r, src[1] if r in weak_i else src[0], np.arange(n)] = 1.0
        q[r, amps.shape[0] + src[1], np.arange(n)] = 1.0
    q /= q.reshape(len(shifts), 2, amps.shape[0], n).sum(axis=2).repeat(amps.shape[0], axis=1)
    return q, tx


def test_find_shift_roll_and_weight_match_jax():
    const = make_constellation("16-QAM", 0.0)
    rng = np.random.default_rng(4)
    n = 6000  # the weak-peak threshold 0.02 n = 120 sits above chance correlations (~40)
    shifts = [3, -7, 0, 5]
    q, tx = _synced_posteriors(rng, const, n, shifts, weak_i=(3,))
    got = find_shift_siso(T(q), T(tx), 21, T(const.amps))
    for r in range(len(shifts)):
        want = j_find_shift_siso(jnp.asarray(q[r]), jnp.asarray(tx[r]), 21, jnp.asarray(const.amps))
        assert int(got[r]) == int(want)
    assert got.tolist() == shifts  # q[t] carries tx[t - s]: shift s, via Q for run 3
    rolled = roll_time(T(q), got)
    weight = margin_weight(n, got)
    for r in range(len(shifts)):
        np.testing.assert_array_equal(rolled[r].numpy(), np.asarray(j_roll_time(jnp.asarray(q[r]), int(got[r]))))
        np.testing.assert_array_equal(weight[r].numpy(), np.asarray(j_margin_weight(n, int(got[r]))))


def test_eval_pack_matches_jax():
    const = make_constellation("16-QAM", 0.0270955)
    rng = np.random.default_rng(6)
    q, tx = _synced_posteriors(rng, const, 1500, [2, -4])
    q = 0.7 * q + 0.3 * rng.dirichlet(np.ones(4), size=(2, 2, 1500)).transpose(0, 1, 3, 2).reshape(2, 8, 1500)
    q = q.astype(np.float32)
    amps, P = const.amps, np.asarray(const.P, np.float32)
    got = _siso_eval_pack(T(q), T(tx), 1500, const, T(amps), T(P))
    for r in range(2):
        want = np.asarray(j_eval_pack(jnp.asarray(q[r]), jnp.asarray(tx[r]), 1500, const,
                                      jnp.asarray(amps), jnp.asarray(P)))
        np.testing.assert_allclose(got[r].numpy(), want, rtol=1e-5, atol=1e-6)
