"""Port parity: the LMMSE / DFE baseline (``models/lmmse_dfe.py``,
``train/dfe.py: run_lmmse_dfe``) against the reference fixtures and the JAX
package on the CPU.

* the filter design against lmmse_dfe.npz (the JAX package's tolerances,
  tests/test_vae_nn.py) and equal to JAX's (the same NumPy code);
* ``complex_fir`` / ``nearest_neighbor`` / ``dfe_equalize`` on dfe_loop.npz:
  the feedforward output at rtol 1e-3, the initial and the decision-feedback
  indices equal (kernel J's plain version on the CPU);
* the same functions against JAX's on shared numpy inputs: the FIR at rtol
  1e-5 (float32 sums in another order), the decisions equal, for 3 and 4
  feedback taps and 16- and 64-point constellations; with no feedback taps
  (the h0 channel, which JAX's scan cannot run) the decisions are the
  nearest-neighbour ones;
* ``run_lmmse_dfe`` (two SNRs, 4,000 symbols, 2 epochs) against JAX's on
  JAX's draws (fed through ``draws``);
* kernel J against its plain version on the card (``requires_cuda``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_equalizer_tpu.core.constellation import sample_levels as j_sample_levels
from vae_equalizer_tpu.models import complex_fir as j_complex_fir
from vae_equalizer_tpu.models import dfe_equalize as j_dfe_equalize
from vae_equalizer_tpu.models.lmmse_dfe import compute_feedback as j_compute_feedback
from vae_equalizer_tpu.models.lmmse_dfe import compute_feedforward as j_compute_feedforward
from vae_equalizer_tpu.models.lmmse_dfe import compute_lmmse as j_compute_lmmse
from vae_equalizer_tpu.models.lmmse_dfe import nearest_neighbor as j_nearest_neighbor
from vae_equalizer_tpu.train.dfe import run_lmmse_dfe as j_run_lmmse_dfe
from vae_equalizer_tpu.utils.config import LmmseDfeConfig as JLmmseDfeConfig
from vae_equalizer_tpu_torch.channels import channel_ir, make_awgn_simulator
from vae_equalizer_tpu_torch.core import make_constellation
from vae_equalizer_tpu_torch.models import (
    complex_fir,
    compute_feedback,
    compute_feedforward,
    compute_lmmse,
    dfe_equalize,
    nearest_neighbor,
)
from vae_equalizer_tpu_torch.ops.dfe_kernel import dfe_decide, dfe_decide_plain, dfe_route
from vae_equalizer_tpu_torch.train.dfe import run_lmmse_dfe
from vae_equalizer_tpu_torch.utils import LmmseDfeConfig

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

T = torch.from_numpy


def _points(mod="64-QAM"):
    c = make_constellation(mod, 0.0)
    return np.stack([c.points.real, c.points.imag]).astype(np.float32)


def _planes(c):
    return np.stack([c.real, c.imag]).astype(np.float32)


def test_filters_golden_and_equal_to_jax(golden):
    g = golden("lmmse_dfe")
    h = (g["h_real"] + 1j * g["h_imag"]).astype(np.complex64)
    snr = float(g["snr"])
    lmmse, ff = compute_lmmse(h, snr, 20, 11), compute_feedforward(h, snr, 11)
    fb = compute_feedback(h, ff)
    for got, key in ((lmmse, "lmmse"), (ff, "ff"), (fb, "fb")):
        np.testing.assert_allclose(got.real, g[f"{key}_real"], rtol=1e-3, atol=1e-6)
        np.testing.assert_allclose(got.imag, g[f"{key}_imag"], rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(lmmse, j_compute_lmmse(h, snr, 20, 11))
    np.testing.assert_array_equal(ff, j_compute_feedforward(h, snr, 11))
    np.testing.assert_array_equal(fb, j_compute_feedback(h, ff))


def test_dfe_loop_golden(golden):
    g, gl = golden("lmmse_dfe"), golden("dfe_loop")
    h = (g["h_real"] + 1j * g["h_imag"]).astype(np.complex64)
    ff = compute_feedforward(h, float(g["snr"]), 11)
    points = T(_points())
    rx = T(np.stack([gl["rx_real"], gl["rx_imag"]]).astype(np.float32))
    ff_out = complex_fir(rx, T(_planes(ff)))
    np.testing.assert_allclose(ff_out[0].numpy(), gl["ff_out_real"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(ff_out[1].numpy(), gl["ff_out_imag"], rtol=1e-3, atol=1e-4)
    init_idx = nearest_neighbor(ff_out, points)
    np.testing.assert_array_equal(init_idx.numpy(), gl["init_idx"])
    dfe_idx = dfe_equalize(ff_out, T(_planes(compute_feedback(h, ff))), points, init_idx)
    assert dfe_idx.dtype == torch.int32
    np.testing.assert_array_equal(dfe_idx.numpy(), gl["dfe_idx"])


@pytest.mark.parametrize("k2,mod", [(4, "64-QAM"), (3, "16-QAM"), (0, "4-QAM")],
                         ids=["k4_64qam", "k3_16qam", "k0_4qam"])
def test_fir_and_decisions_match_jax(k2, mod):
    rng = np.random.default_rng(k2)
    points = _points(mod)
    n, B = 2500, 3
    tx = points[:, rng.integers(0, points.shape[1], size=(B, n))].transpose(1, 0, 2)
    rx = (tx + 0.05 * rng.normal(size=tx.shape)).astype(np.float32)
    h = (0.3 * rng.normal(size=(B, 2, 11))).astype(np.float32)
    h[:, 0, 5] += 1.0
    fb = (0.2 * rng.normal(size=(B, 2, k2))).astype(np.float32)
    ff_out = complex_fir(T(rx), T(h))  # one filter per signal
    init = nearest_neighbor(ff_out, T(points))
    got = dfe_equalize(ff_out, T(fb), T(points), init)
    for b in range(B):
        want_ff = j_complex_fir(jnp.asarray(rx[b]), jnp.asarray(h[b]))
        np.testing.assert_allclose(ff_out[b].numpy(), np.asarray(want_ff), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(
            init[b].numpy(), np.asarray(j_nearest_neighbor(jnp.asarray(ff_out[b].numpy()),
                                                           jnp.asarray(points))))
        if k2:
            want = j_dfe_equalize(jnp.asarray(ff_out[b].numpy()), jnp.asarray(fb[b]),
                                  jnp.asarray(points), jnp.asarray(init[b].numpy()))
        else:  # JAX's scan cannot carry an empty state (h0's DFE): no feedback is
            want = init[b].numpy()  # the nearest-neighbour decision of every symbol
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    # a shared filter broadcasts over the signals; the CPU dispatch is the plain version
    assert torch.equal(complex_fir(T(rx), T(h[0]))[1], complex_fir(T(rx[1]), T(h[0])))
    assert torch.equal(dfe_decide(ff_out.contiguous(), T(fb), T(points), init),
                       dfe_decide_plain(ff_out, T(fb), T(points), init))


SNRS = (18.0, 22.0)
SMALL = dict(n_valid=4000, num_epochs=2)


def _jax_draws(cfg, key):
    """run_lmmse_dfe's per-(SNR, epoch) draws from JAX's key chain
    (train/dfe.py:85-88, channels/awgn.py:79-95)."""
    const = make_constellation(cfg.mod, cfg.nu)
    h_up, m_orig = channel_ir(cfg.channel, 1)
    sim = make_awgn_simulator(const, 18.0, h_up, m_orig, cfg.n_valid, 1, pulse="rc")
    amps, P = jnp.asarray(const.amps), jnp.asarray(const.P, jnp.float32)
    out = {}
    for si in range(len(SNRS)):
        for epoch in range(cfg.num_epochs):
            key, k = jax.random.split(key)
            k_sym, k_noise = jax.random.split(k)
            out[si, epoch] = (T(np.array(j_sample_levels(k_sym, amps, P, (2, sim.n_conv)))),
                              T(np.array(jax.random.normal(k_noise, (2, sim.sig_len), jnp.float32))))
    return out


def test_run_lmmse_dfe_matches_jax_on_jax_draws():
    key = jax.random.PRNGKey(3)
    res_j = j_run_lmmse_dfe(JLmmseDfeConfig(**SMALL), key, snrs=SNRS)
    cfg = LmmseDfeConfig(**SMALL)
    draws = _jax_draws(cfg, key)
    seen = []
    res = run_lmmse_dfe(cfg, 0, device="cpu", snrs=SNRS, draws=lambda si, e: draws[si, e],
                        progress=lambda e, m: seen.append((e, m["snr"])))
    assert res["ser_mmse"].shape == res["ser_dfe"].shape == (2, 2)
    np.testing.assert_array_equal(res["snrs"], np.asarray(res_j["snrs"]))
    assert seen == [(0, 18.0), (1, 18.0), (0, 22.0), (1, 22.0)]
    assert np.all(res["ser_mmse"][0] > 0.05) and np.all(res["ser_dfe"][1] < res["ser_mmse"][1])
    # the same draws and filters; the FIRs' float32 sums in another order may
    # move a decision at a boundary: at most one symbol a frame
    np.testing.assert_allclose(res["ser_mmse"], res_j["ser_mmse"], rtol=0, atol=1.01 / cfg.n_valid)
    np.testing.assert_allclose(res["ser_dfe"], res_j["ser_dfe"], rtol=0, atol=1.01 / cfg.n_valid)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ for sm_90a)")
    return torch.device("cuda")


def _midpoints(points: np.ndarray, rng, n: int) -> np.ndarray:
    """(2, n) values on exact float midpoints between adjacent levels of each
    axis of a grid table, on its levels and beyond its outer levels."""
    L = round(points.shape[-1] ** 0.5)
    out = []
    for lv in (points[0].reshape(L, L)[:, 0], points[1].reshape(L, L)[0]):
        pool = np.concatenate([(lv[:-1] + lv[1:]) / np.float32(2), lv, 3 * lv[[0, -1]]])
        out.append(pool[rng.integers(0, pool.size, n)])
    return np.stack(out).astype(np.float32)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("k2,mod,ties", [(4, "64-QAM", False), (3, "16-QAM", False), (0, "4-QAM", False),
                                         (2, "256-QAM", False), (4, "64-QAM", True), (1, "256-QAM", True),
                                         (3, "8-PSK", False)],
                         ids=["k4_64qam", "k3_16qam", "k0_4qam", "k2_256qam", "k4_64qam_ties",
                              "k1_256qam_ties", "k3_8psk_general"])
def test_kernel_j_matches_plain_on_card(cuda, k2, mod, ties):
    """Both routes on the card: the grid route on every QAM (with ``ties``,
    chains 0-1 sit on exact midpoints between levels, at grid corners and
    beyond the outer levels with no feedback: the first index must win), the
    general route on 8-PSK."""
    rng = np.random.default_rng(k2)
    if mod == "8-PSK":
        ang = np.arange(8) * np.pi / 4
        pts = np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)
    else:
        pts = _points(mod)
    points = T(pts).to(cuda)
    assert dfe_route(points)[0] == ("general" if mod == "8-PSK" else "grid")
    B, n = 5, 3000
    ff_np = (0.8 * rng.normal(size=(B, 2, n))).astype(np.float32)
    fb_np = (0.3 * rng.normal(size=(B, 2, k2))).astype(np.float32)
    if ties:
        ff_np[:2] = np.stack([_midpoints(pts, rng, n) for _ in range(2)])
        fb_np[:2] = 0.0
    ff, fb = T(ff_np).to(cuda), T(fb_np).to(cuda)
    init = nearest_neighbor(ff, points).contiguous()
    n0 = dfe_decide.launches
    got = dfe_decide(ff, fb, points, init)
    torch.cuda.synchronize()
    assert dfe_decide.launches == n0 + 1
    assert torch.equal(got, dfe_decide_plain(ff, fb, points, init))
