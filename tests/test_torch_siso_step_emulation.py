"""Kernels F and G's CUDA blocks, compiled for the host.

``csrc/siso_step.cuh`` compiles as plain C++ under ``SISO_HOST_EMULATION``,
in which one thread runs every item of every phase and computes each
item's lane partials, and each thread's share of a block total, one after
another, closing them with the card's xor butterfly and cross-warp order,
so the card's partition and summation order are reproduced (barriers are
no-ops, cp.async a copy). ``csrc/siso_host_emulation.cpp`` wraps it in the
siso library's C launchers; the test builds it with the host's C++
compiler, patches ``ops/_build.py``'s ``load`` / ``stream`` to return it,
and runs the wrappers' own launch code (``ops/elbo_siso_kernel.py:
_launch``, ``ops/siso_frame_kernel.py: _launch``) on CPU tensors against
``vae_siso_loss_and_grad_plain`` / ``vae_siso_experiment_train_plain`` at
chip_smoke.py's phase 10 / 11a tolerances, on the AWGN channel's samples
(h1, 24 dB). It is the CPU's only check of the blocks' index arithmetic
(padded planes, lane splits, the level loops, the eval slots); the card
runs the same source (``tests/test_torch_siso_kernels.py``,
``chip_smoke.py``). It skips where no C++ compiler is found.
"""

import ctypes
import dataclasses
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

import chip_smoke
from vae_equalizer_tpu_torch.models import dirac_taps_siso, siso_fir_init
from vae_equalizer_tpu_torch.ops import _build
from vae_equalizer_tpu_torch.ops import elbo_siso_kernel as esk
from vae_equalizer_tpu_torch.ops import siso_frame_kernel as sfk
from vae_equalizer_tpu_torch.train import awgn as train_awgn
from vae_equalizer_tpu_torch.utils import AwgnVaeLeConfig

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The emulated siso library's typed entry points, built once."""
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler found to build csrc/siso_host_emulation.cpp")
    so = tmp_path_factory.mktemp("siso_host") / "libsiso_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    "-DSISO_HOST_EMULATION", "-o", str(so), str(_build.CSRC / "siso_host_emulation.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    fns = {}
    for name, argtypes in _build._SIGNATURES["siso"].items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return types.SimpleNamespace(lib=lib, **fns)


@pytest.fixture
def emulated(host_lib, monkeypatch):
    """The emulated library in place of the card's; the wrappers' launch counts
    are restored afterwards (other tests of the process read them)."""
    monkeypatch.setattr(_build, "load", lambda: host_lib)
    monkeypatch.setattr(_build, "stream", lambda dev: None)
    for wrapper in (esk.vae_siso_loss_and_grad, sfk.vae_siso_experiment_train):
        monkeypatch.setattr(wrapper, "launches", wrapper.launches)
    return host_lib


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


_DIVISION_CHECK = r"""
// The body's two division forms against IEEE float division (round to nearest).
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
static float f_of(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
int main(int argc, char** argv) {
  const long long n = std::atoll(argv[1]);
  std::mt19937_64 g(12345);
  long long bad_fdiv = 0, bad_mark = 0;
  for (long long i = 0; i < n; ++i) {
    const uint64_t r = g();
    // fdiv: a any finite float (zero and denormals included), b > 0 normal in
    // [2^-106, 2^94); y = RN(1 / b) moved by -4..4 double ulps
    uint32_t ua = (uint32_t)r & 0x7fffffffu;
    if ((ua >> 23) == 0xff) ua = 0;
    const uint32_t ub = ((uint32_t)(r >> 32) & 0x7fffffu) | ((uint32_t)(21 + (r >> 55) % 200) << 23);
    const float a = (i & 1) ? -f_of(ua) : f_of(ua), b = f_of(ub), want = a / b;
    if (std::isfinite(want))
      for (int k = -4; k <= 4; ++k) {
        double y = 1.0 / (double)b;
        for (int s = 0; s < (k < 0 ? -k : k); ++s) y = std::nextafter(y, k < 0 ? 0.0 : 1e300);
        const float got = (float)((double)a * y);
        bad_fdiv += std::memcmp(&got, &want, 4) != 0;
      }
    // Markstein: a = 0 or in [2^-100, 2^60), b in [2^-40, 2^40), y = RN(1 / b)
    const uint32_t ma = (i % 97 == 0) ? 0u : (((uint32_t)r & 0x7fffffu) | ((uint32_t)(27 + (r >> 23) % 160) << 23));
    const uint32_t mb = ((uint32_t)(r >> 32) & 0x7fffffu) | ((uint32_t)(87 + (r >> 56) % 80) << 23);
    const float x = f_of(ma), v = f_of(mb), yv = 1.f / v, q0 = x * yv;
    const float q1 = std::fmaf(std::fmaf(-q0, v, x), yv, q0), wq = x / v;
    bad_mark += std::memcmp(&q1, &wq, 4) != 0;
  }
  std::printf("%lld %lld\n", bad_fdiv, bad_mark);
  return 0;
}
"""


def test_division_forms_are_ieee_division(tmp_path):
    """The two branch-free divisions of csrc/siso_step.cuh give the IEEE float
    quotient: (float)(a * y) in double with y within 4 double ulps of 1 / b
    (fdiv; 10^7 pairs, each with 9 values of y, zero and denormal dividends
    included) and Markstein's x * RN(1 / v) with one fused correction for
    x = 0 or x >= 2^-100 (the metric's division by var; 10^7 pairs)."""
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler found")
    src, exe = tmp_path / "div.cpp", tmp_path / "div"
    src.write_text(_DIVISION_CHECK)
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-o", str(exe), str(src)], check=True,
                   capture_output=True, text=True)
    out = subprocess.run([str(exe), "10000000"], check=True, capture_output=True, text=True).stdout
    assert out.split() == ["0", "0"], out
