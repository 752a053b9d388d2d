"""Port parity: the DP frame evaluation (sync, alignment, SER, MI).

Both eval branches: the VAE kernel's statistics streams and the CMA path's
posteriors (``find_shift_dp``, ``align_tx_dp``, ``ser_iqflip``,
``mutual_information_ambiguity``). Every function runs with a leading runs
axis R = 2; each run is held against the JAX function on the same numpy
inputs, and the sync and SER functions also against the torch reference
fixtures (find_shift.npz, ser_dp.npz).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_equalizer_tpu.metrics.mi import mutual_information_ambiguity as j_mi_amb
from vae_equalizer_tpu.metrics.mi import mutual_information_ambiguity_mb_stats as j_mi_stats
from vae_equalizer_tpu.metrics.ser import _decode_levels as j_decode
from vae_equalizer_tpu.metrics.ser import ser_constell_shaping as j_ser_const
from vae_equalizer_tpu.metrics.ser import ser_iqflip as j_ser_iqflip
from vae_equalizer_tpu.metrics.ser import ser_iqflip_from_dec as j_ser_dec
from vae_equalizer_tpu.metrics.sync import _dp_shift_core as j_shift_core
from vae_equalizer_tpu.metrics.sync import expectation_i as j_expectation_i
from vae_equalizer_tpu.metrics.sync import find_shift_dp as j_find_shift_dp
from vae_equalizer_tpu.metrics.sync import find_shift_symb_dp as j_find_symb
from vae_equalizer_tpu.train.eval_utils import align_idx_dp as j_align_idx
from vae_equalizer_tpu.train.eval_utils import align_tx_dp as j_align_tx
from vae_equalizer_tpu.train.eval_utils import batch_cut_weight as j_batch_cut
from vae_equalizer_tpu.train.eval_utils import margin_weight_maxshift as j_margin
from vae_equalizer_tpu_torch.core import make_constellation
from vae_equalizer_tpu_torch.metrics import (
    expectation_i,
    find_shift_dp,
    find_shift_symb_dp,
    mutual_information_ambiguity,
    mutual_information_ambiguity_mb_stats,
    ser_constell_shaping,
    ser_iqflip,
    ser_iqflip_from_dec,
)
from vae_equalizer_tpu_torch.metrics.ser import _decode_levels
from vae_equalizer_tpu_torch.metrics.sync import _dp_shift_core
from vae_equalizer_tpu_torch.train.eval_utils import (
    align_idx_dp,
    align_tx_dp,
    batch_cut_weight,
    margin_weight_maxshift,
)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

R, N_MB, BL = 2, 8, 50
N = N_MB * BL


def _frame(seed=0, shifts=((3, -2), (0, 4)), swaps=(0, 1), noise=0.08):
    """R runs of DP tx levels and an equalizer output that is the tx delayed
    per pol (and pol-swapped for run 1), plus noise; with the demapper's
    statistics mm/s1, the argmax decisions and E_q[x^I] computed from it."""
    const = make_constellation("64-QAM", 0.0)
    rng = np.random.default_rng(seed)
    amps = const.amps
    idx = rng.integers(0, 8, size=(R, 2, 2, N))
    tx = amps[idx]
    out = np.empty_like(tx)
    for r in range(R):
        for j in range(2):
            src = (j + swaps[r]) % 2
            out[r, j] = np.roll(tx[r, src], shifts[r][src], axis=-1)
    out = (out + noise * rng.normal(size=out.shape)).astype(np.float32)
    var = np.full(2, 0.004, np.float32)
    met = (out[..., None, :] - amps[:, None]) ** 2 / (2 * var[None, :, None, None, None]) \
        + const.nu_sc * (amps ** 2)[:, None]
    mm = met.min(axis=-2)
    e = np.exp(mm[..., None, :] - met)
    s1 = e.sum(axis=-2)
    q = e / s1[..., None, :]
    dec = np.argmax(q, axis=-2).astype(np.int32)
    eq = (q[:, :, 0] * amps[:, None]).sum(axis=-2).astype(np.float32)  # (R, 2, N)
    to_mb = lambda a: np.moveaxis(a.reshape(a.shape[:-1] + (N_MB, BL)), -2, 1)  # (R, n_mb, ..., bl)
    return dict(const=const, tx=tx.astype(np.float32), out=out, var=var, mm=mm.astype(np.float32),
                q=q.reshape(R, 2, 16, N).astype(np.float32),
                s1=s1.astype(np.float32), dec=dec, eq=eq, out_mb=to_mb(out),
                mm_mb=to_mb(mm.astype(np.float32)), s1_mb=to_mb(s1.astype(np.float32)))


T = torch.from_numpy


def test_shift_search_matches_golden_and_jax(golden):
    g = golden("find_shift")
    amps = g["amp_levels"]
    e = (g["q"][:, :8] * amps[:, None]).sum(axis=1).astype(np.float32)  # E_q[x^I]
    # run 1: the same frame with its pols swapped and delayed by 2 symbols
    e2 = np.stack([e, np.roll(e[::-1], 2, axis=-1)])
    out2 = np.stack([g["out"], np.roll(g["out"][::-1], 2, axis=-1)])
    tx2 = np.stack([g["tx"], g["tx"]])
    shift, r = _dp_shift_core(T(e2), T(tx2), 21)
    shift_c, r_c = find_shift_symb_dp(T(out2), T(tx2), 21)
    np.testing.assert_array_equal(shift[0].numpy(), g["shift"])
    assert int(r[0]) == int(g["r"])
    np.testing.assert_array_equal(shift_c[0].numpy(), g["shift_symb"])
    assert int(r_c[0]) == int(g["r_symb"])
    for run in range(2):  # each run against JAX, full-length and windowed
        for corr_len in (None, 1000):
            s_j, r_j = j_shift_core(jnp.asarray(e2[run]), jnp.asarray(tx2[run]), 21, corr_len=corr_len)
            s_t, r_t = _dp_shift_core(T(e2), T(tx2), 21, corr_len=corr_len)
            np.testing.assert_array_equal(s_t[run].numpy(), np.asarray(s_j))
            assert int(r_t[run]) == int(r_j)
            s_j, r_j = j_find_symb(jnp.asarray(out2[run]), jnp.asarray(tx2[run]), 21, corr_len=corr_len)
            s_t, r_t = find_shift_symb_dp(T(out2), T(tx2), 21, corr_len=corr_len)
            np.testing.assert_array_equal(s_t[run].numpy(), np.asarray(s_j))
            assert int(r_t[run]) == int(r_j)


def test_align_and_weights_match_jax():
    f = _frame(1)
    idx = _decode_levels(T(f["tx"]), 8).to(torch.int8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_decode(jnp.asarray(f["tx"]), 8)))
    shift, r = _dp_shift_core(T(f["eq"]), T(f["tx"]), 21)
    # the synthetic delays are found: run 0 XY with (3, -2), run 1 swapped
    np.testing.assert_array_equal(shift.numpy(), [[3, -2], [4, 0]])
    np.testing.assert_array_equal(r.numpy(), [0, 1])
    s0 = shift[:, 0, None, None]
    ms = shift.abs().max(dim=-1).values[:, None, None]
    idx_al, w_al = align_idx_dp(idx, shift, r, lambda t: batch_cut_weight(N_MB, BL, s0, ms, 10, t=t))
    for run in range(R):
        sj, msj = jnp.asarray(shift[run].numpy()), int(ms[run])
        ij, wj = j_align_idx(jnp.asarray(idx[run].numpy()), sj, jnp.int32(int(r[run])),
                             lambda t: j_batch_cut(N_MB, BL, sj[0], msj, 10, t=t))
        np.testing.assert_array_equal(idx_al[run].numpy(), np.asarray(ij))
        np.testing.assert_array_equal(w_al[run].numpy(), np.asarray(wj))
        np.testing.assert_array_equal(
            batch_cut_weight(N_MB, BL, int(s0[run]), msj, 10).numpy(),
            np.asarray(j_batch_cut(N_MB, BL, int(s0[run]), msj, 10)))
        t = (torch.arange(N) + int(shift[run, 0])) % N
        np.testing.assert_array_equal(
            margin_weight_maxshift(N, msj, t=t).numpy(),
            np.asarray(j_margin(N, msj, t=jnp.asarray(t.numpy()))))


def test_ser_matches_golden(golden):
    g = golden("ser_dp")
    n = 8
    q = g["q"].reshape(2, 2, n, -1)
    dec = np.argmax(q, axis=2)
    tx_idx = _decode_levels(T(g["tx"]), n)
    got = ser_iqflip_from_dec(T(dec), None, n, tx_idx=tx_idx)
    np.testing.assert_allclose(got.numpy(), g["ser_iqflip"], atol=1e-6)
    got_c = ser_constell_shaping(T(g["rx"]), None, T(g["amp_levels"]), float(g["nu_sc"]),
                                 T(g["var"]), tx_idx=tx_idx)
    np.testing.assert_allclose(got_c.numpy(), g["ser_constell"], atol=1e-6)
    # the amplitude-tx path decodes to the same indices
    np.testing.assert_array_equal(
        ser_constell_shaping(T(g["rx"]), T(g["tx"]), T(g["amp_levels"]), float(g["nu_sc"]),
                             T(g["var"])).numpy(), got_c.numpy())


@pytest.mark.parametrize("noise", [0.08, 0.2])
def test_ser_and_mi_stats_match_jax_per_run(noise):
    f = _frame(2, noise=noise)
    c = f["const"]
    idx = _decode_levels(T(f["tx"]), 8).to(torch.int8)
    rng = np.random.default_rng(3)
    w = (rng.random((R, 2, N)) > 0.1).astype(np.float32)  # per-pol masks
    amps, P, var = T(c.amps), T(np.asarray(c.P, np.float32)), T(f["var"])
    ser_s = ser_iqflip_from_dec(T(f["dec"]), None, 8, weight=T(w), tx_idx=idx)
    ser_c = ser_constell_shaping(T(f["out"]), None, amps, c.nu_sc, var, weight=T(w), tx_idx=idx)
    mi = mutual_information_ambiguity_mb_stats(T(f["out_mb"]), T(f["mm_mb"]), T(f["s1_mb"]), None,
                                               amps, P, c.nu_sc, var, weight=T(w), tx_idx=idx)
    assert ser_s.shape == ser_c.shape == mi.shape == (R, 2)
    ja = lambda a: jnp.asarray(np.asarray(a))
    for run in range(R):
        ij = ja(idx[run])
        np.testing.assert_allclose(
            ser_s[run].numpy(), np.asarray(j_ser_dec(ja(f["dec"][run]), None, 8, weight=ja(w[run]), tx_idx=ij)),
            rtol=1e-6)
        np.testing.assert_allclose(
            ser_c[run].numpy(),
            np.asarray(j_ser_const(ja(f["out"][run]), None, ja(c.amps), c.nu_sc, ja(f["var"]),
                                   weight=ja(w[run]), tx_idx=ij)), rtol=1e-6)
        mi_j = j_mi_stats(ja(f["out_mb"][run]), ja(f["mm_mb"][run]), ja(f["s1_mb"][run]), None,
                          ja(c.amps), ja(np.asarray(c.P, np.float32)), c.nu_sc, ja(f["var"]),
                          weight=ja(w[run]), tx_idx=ij)
        # f32 sums of ~400 log2 terms in another order
        np.testing.assert_allclose(mi[run].numpy(), np.asarray(mi_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("noise", [0.08, 0.2])
def test_posterior_eval_matches_jax_per_run(noise):
    """The CMA path's eval chain: E_q sync, tx/weight alignment, soft SER and
    MI from the posteriors q (R, 2, 2n, N)."""
    f = _frame(5, noise=noise)
    c = f["const"]
    q, tx = T(f["q"]), T(f["tx"])
    amps, P = T(c.amps), T(np.asarray(c.P, np.float32))
    shift, r = find_shift_dp(q, tx, 21, amps, corr_len=300)
    np.testing.assert_array_equal(shift.numpy(), [[3, -2], [4, 0]])
    np.testing.assert_array_equal(r.numpy(), [0, 1])
    ms = shift.abs().max(dim=-1).values
    w = margin_weight_maxshift(N, ms[:, None], t=torch.arange(N))  # (R, N)
    tx_al, w_al = align_tx_dp(tx, shift, r, w)
    ser = ser_iqflip(q, tx_al, weight=w_al)
    mi = mutual_information_ambiguity(q, tx_al, amps, P, weight=w_al)
    mi_all = mutual_information_ambiguity(q, tx, amps, P)
    assert ser.shape == mi.shape == mi_all.shape == (R, 2)
    ja = lambda a: jnp.asarray(np.asarray(a))
    for run in range(R):
        qj, txj = ja(f["q"][run]), ja(f["tx"][run])
        np.testing.assert_allclose(expectation_i(q, amps)[run].numpy(),
                                   np.asarray(j_expectation_i(qj, ja(c.amps))), rtol=1e-6, atol=1e-7)
        s_j, r_j = j_find_shift_dp(qj, txj, 21, ja(c.amps), corr_len=300)
        np.testing.assert_array_equal(shift[run].numpy(), np.asarray(s_j))
        assert int(r[run]) == int(r_j)
        tx_al_j, w_al_j = j_align_tx(txj, s_j, r_j, j_margin(N, int(ms[run])))
        np.testing.assert_array_equal(tx_al[run].numpy(), np.asarray(tx_al_j))
        np.testing.assert_array_equal(w_al[run].numpy(), np.asarray(w_al_j))
        np.testing.assert_allclose(ser[run].numpy(), np.asarray(j_ser_iqflip(qj, tx_al_j, weight=w_al_j)),
                                   rtol=1e-6)
        np.testing.assert_allclose(ser_iqflip(q, tx)[run].numpy(), np.asarray(j_ser_iqflip(qj, txj)),
                                   rtol=1e-6)
        # f32 sums of ~400 log2 terms in another order
        mi_j = j_mi_amb(qj, tx_al_j, ja(c.amps), ja(np.asarray(c.P, np.float32)), weight=w_al_j)
        np.testing.assert_allclose(mi[run].numpy(), np.asarray(mi_j), rtol=1e-5, atol=1e-5)
        mi_j = j_mi_amb(qj, txj, ja(c.amps), ja(np.asarray(c.P, np.float32)))
        np.testing.assert_allclose(mi_all[run].numpy(), np.asarray(mi_j), rtol=1e-5, atol=1e-5)
