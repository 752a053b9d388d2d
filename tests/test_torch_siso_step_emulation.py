"""Kernels F and G's CUDA blocks, compiled for the host.

``csrc/siso_step.cuh`` compiles as plain C++ under ``VAE_HOST_EMULATION``
(``csrc/portable.cuh``), in which one thread runs every item of every phase
and computes each item's lane partials, and each thread's share of a block
total, one after another, closing them with the card's xor butterfly and
cross-warp order, so the card's partition and summation order are reproduced
(barriers are no-ops, cp.async a copy). ``csrc/siso_host_emulation.cpp``
wraps it in the siso library's C launchers; ``ops/_build.py: host_library``
builds it with the host's C++ compiler; the test patches ``ops/_build.py``'s
``load`` / ``stream`` to return it, and runs the wrappers' own launch code
(``ops/elbo_siso_kernel.py: _launch``, ``ops/siso_frame_kernel.py:
_launch``) on CPU tensors against ``vae_siso_loss_and_grad_plain`` /
``vae_siso_experiment_train_plain`` at chip_smoke.py's phase 10 / 11a
tolerances, on the AWGN channel's samples (h1, 24 dB). It is the CPU's only
check of the blocks' index arithmetic (padded planes, lane splits, the level
loops, the eval slots); the card runs the same source
(``tests/test_torch_siso_kernels.py``, ``chip_smoke.py``). It skips where no
C++ compiler is found.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import kernel_emulation
from vae_equalizer_tpu_torch.models import dirac_taps_siso, siso_fir_init
from vae_equalizer_tpu_torch.ops import elbo_siso_kernel as esk
from vae_equalizer_tpu_torch.ops import siso_frame_kernel as sfk
from vae_equalizer_tpu_torch.train import awgn as train_awgn
from vae_equalizer_tpu_torch.utils import AwgnVaeLeConfig

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host_lib():
    return kernel_emulation.host_lib("siso")


@pytest.fixture
def emulated(host_lib, monkeypatch):
    return kernel_emulation.emulate(monkeypatch, host_lib)


def _setup(mod, m, bl, nb, epochs, R, seed):
    """AwgnVaeLeConfig() cut to bl symbols a minibatch and nb a frame: the h1
    channel at 24 dB driven by numpy-drawn levels and noise, R runs of
    ``epochs`` frames; the near-Dirac start of chip_smoke phase 11a."""
    cfg = dataclasses.replace(AwgnVaeLeConfig(), mod=mod, m_est=m, batch_len=bl, n_train=nb * bl)
    const, sims, amps, P, var = train_awgn._setup(cfg, "cpu")
    sim = sims["train"]
    rng = np.random.default_rng(seed)
    lev = rng.choice(const.amps, p=np.asarray(const.P) / np.sum(const.P), size=(R, epochs, 2, sim.n_conv))
    noise = rng.normal(size=(R, epochs, 2, sim.sig_len))
    rx = sim.physics(torch.from_numpy(lev.astype(np.float32)), torch.from_numpy(noise.astype(np.float32)))[0]
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    w0 = (siso_fir_init(m) + T(0.01 * rng.normal(size=(R, 1, 2, m)))).contiguous()
    h0 = (dirac_taps_siso(m) + T(0.01 * rng.normal(size=(R, 2, m)))).contiguous()
    return cfg, const, amps, P, var, rx.contiguous(), w0, h0


def _close_f(got, want):
    """Phase 10's tolerances: loss rtol 1e-5; gw, gh, q and out rtol 1e-4 over
    1e-4 of each tensor's scale."""
    errs: dict = {}
    chip_smoke._check("loss", got[0], want[0], 1e-5, 0.0, errs)
    for name, g, w in zip(("gw", "gh", "q", "out"), got[1:], want[1:]):
        assert g.shape == w.shape, name
        chip_smoke._check(name, g, w, 1e-4, 1e-4 * float(w.abs().max()), errs)
    return errs


F_CASES = {
    "64qam_m25_bl60": ("64-QAM", 25, 60),
    "64qam_m7_bl48": ("64-QAM", 7, 48),
    "16qam_m25_bl40": ("16-QAM", 25, 40),
    "16qam_m7_bl56": ("16-QAM", 7, 56),
}


@pytest.mark.parametrize("case", list(F_CASES), ids=list(F_CASES))
def test_kernel_f_block_matches_plain(emulated, case):
    """Kernel F's block (one minibatch, R = 3) against the closed-form plain step."""
    mod, m, bl = F_CASES[case]
    cfg, const, amps, P, var, rx, w0, h0 = _setup(mod, m, bl, 1, 1, 3, seed=m + bl)
    args = (w0, h0, rx[:, 0, :, : 2 * bl].contiguous(), amps, const.amp_mean, var, P)
    n0 = esk.vae_siso_loss_and_grad.launches
    got = esk._launch(*args)
    assert esk.vae_siso_loss_and_grad.launches == n0 + 1
    _close_f(got, esk.vae_siso_loss_and_grad_plain(*args))


G_CASES = {
    "64qam_m25_bl60": ("64-QAM", 25, 60, 1),
    "64qam_m7_bl48_epe2": ("64-QAM", 7, 48, 2),
    "16qam_m25_bl40": ("16-QAM", 25, 40, 1),
}


@pytest.mark.parametrize("case", list(G_CASES), ids=list(G_CASES))
def test_kernel_g_block_matches_plain(emulated, case):
    """Kernel G's block over 2 epochs of 3 minibatches (R = 2) against the plain
    engine at phase 11a's tolerances: losses rtol 1e-4; w, h and the eval
    slots rtol 1e-2 over 1e-4. A second call from the first one's state
    (step0 = 6) continues the AMSGrad step count."""
    mod, m, bl, epe = G_CASES[case]
    cfg, const, amps, P, var, rx, w0, h0 = _setup(mod, m, bl, 3, 4, 2, seed=3 * m + bl)
    kw = dict(bl_sym=bl, n_batches=3, epe=epe)
    state = (w0, h0, sfk.siso_frame_opt_init({"w": w0, "h": h0}))
    for part, step0 in ((slice(0, 2), 0), (slice(2, 4), 6)):
        args = (*state, rx[:, part].contiguous(), amps, const.amp_mean, var, P, cfg.lr)
        n0 = sfk.vae_siso_experiment_train.launches
        got = sfk._launch(*args, **kw, step0=step0)
        assert sfk.vae_siso_experiment_train.launches == n0 + 1
        want = sfk.vae_siso_experiment_train_plain(*args, **kw, step0=step0)
        errs: dict = {}
        chip_smoke._check("losses", got[3], want[3], 1e-4, 0.0, errs)
        for i, name in ((0, "w"), (1, "h"), (4, "w_ev"), (5, "h_ev")):
            assert got[i].shape == want[i].shape, name
            chip_smoke._check(name, got[i], want[i], 1e-2, 1e-4, errs)
        for k in got[2]:
            chip_smoke._check(k, got[2][k], want[2][k], 1e-2, 1e-4 * float(want[2][k].abs().max()), errs)
        state = want[:3]


@pytest.mark.parametrize("kernel", ["F", "G"])
def test_runs_are_single_run_calls_and_repeat(emulated, kernel):
    """R = 3 in one call equals three single-run calls bit for bit; two calls
    give the same bits; the clocks pointer changes no output (the host has no
    clock, so every phase reads 0 there)."""
    cfg, const, amps, P, var, rx, w0, h0 = _setup("64-QAM", 25, 48, 3, 2, 3, seed=5)
    c = (amps, const.amp_mean, var, P)

    def launch(r, **kw):
        sl = slice(None) if r is None else slice(r, r + 1)
        w, h = w0[sl].contiguous(), h0[sl].contiguous()
        if kernel == "F":
            return esk._launch(w, h, rx[sl, 0, :, :96].contiguous(), *c, **kw)
        opt = sfk.siso_frame_opt_init({"w": w, "h": h})
        return sfk._launch(w, h, opt, rx[sl].contiguous(), *c, cfg.lr, 48, 3, 1, 0, **kw)

    def flat(out):
        """Every output with its runs axis first (G's losses and eval slots
        carry it second)."""
        ts = [t for o in out for t in (o.values() if isinstance(o, dict) else (o,))]
        return [t.movedim(1, 0) if kernel == "G" and i >= 8 else t for i, t in enumerate(ts)]

    full = flat(launch(None))
    for r in range(3):
        for a, b in zip(flat(launch(r)), full):
            assert torch.equal(a[0], b[r])
    clocks = torch.ones(len(esk.SISO_CLOCK_PHASES), dtype=torch.int64)
    for a, b in zip(flat(launch(None, clocks=clocks)), full):
        assert torch.equal(a, b)
    assert clocks.tolist() == [0] * len(esk.SISO_CLOCK_PHASES)


def test_division_forms_are_ieee_division(host_lib):
    """The two branch-free divisions of csrc/siso_step.cuh give the IEEE float
    quotient: (float)(a * y) in double with y within 4 double ulps of 1 / b
    (fdiv; 10^7 pairs, each with 9 values of y, zero and denormal dividends
    included) and Markstein's x * RN(1 / v) with one fused correction for
    x = 0 or x >= 2^-100 (the metric's division by var; 10^7 pairs;
    ``csrc/siso_host_emulation.cpp: vae_siso_division_check``)."""
    check = host_lib.vae_siso_division_check
    check.argtypes, check.restype = [ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)], None
    bad = (ctypes.c_longlong * 2)()
    check(10_000_000, bad)
    assert list(bad) == [0, 0]
