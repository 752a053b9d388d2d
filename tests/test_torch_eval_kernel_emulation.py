"""Kernel K's CUDA body, compiled for the host.

``csrc/dp_eval_step.cuh`` compiles as plain C++ under
``DP_EVAL_HOST_EMULATION``, in which one "thread" runs every item (a warp of
one lane; barriers are no-ops) and a run's cluster of blocks runs phase by
phase, as its cluster barriers order it on the card.
``csrc/dp_eval_host_emulation.cpp`` wraps it in the eval library's C
launcher; the test builds it with the host's C++ compiler (no contraction
into fused multiply-adds, as the card's build), patches ``ops/_build.py``'s
``load`` / ``stream`` to return it, and runs the wrapper's own launch code
(``ops/eval_kernel.py: _launch``) on CPU tensors against the plain version,
``train/dp.py: _dp_frame_eval_mb``: SERs, shift and r exact, MI within
1e-6 bits (each per-symbol term is an expf and a log2f, and the host's
libm and PyTorch's round them apart by an ulp now and then). The streams
are made as kernel B lays them out, from tx rolled by a known shift per pol
(and the pols swapped) plus noise, so each sync finds a clear peak. It is
the CPU's only check of K's index arithmetic; the card runs the same source
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). It skips where no C++
compiler is found.
"""

import ctypes
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from vae_equalizer_tpu_torch.core import demapper_noise_var, make_constellation
from vae_equalizer_tpu_torch.ops import _build, eval_kernel
from vae_equalizer_tpu_torch.train import dp as train_dp
from vae_equalizer_tpu_torch.train.eval_utils import BatchCutWeight, MarginWeight

torch.set_num_threads(1)

# per run: the shift of each equalizer pol against its tx pol, and the swap
SHIFTS = ((3, 3, 0), (-10, -10, 1), (10, 7, 0), (0, 0, 1), (-4, 2, 0), (6, 6, 1), (-7, -9, 0),
          (1, 1, 1))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The emulated eval library's typed entry point, built once."""
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler found to build csrc/dp_eval_host_emulation.cpp")
    so = tmp_path_factory.mktemp("eval_host") / "libdp_eval_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    "-DDP_EVAL_HOST_EMULATION", "-o", str(so),
                    str(_build.CSRC / "dp_eval_host_emulation.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    fns = {}
    for name, argtypes in _build._SIGNATURES["eval"].items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return types.SimpleNamespace(lib=lib, **fns)


@pytest.fixture
def emulated(host_lib, monkeypatch):
    """The emulated library in place of the card's; the wrapper's launch count
    is restored afterwards (other tests of the process read it)."""
    monkeypatch.setattr(_build, "load", lambda: host_lib)
    monkeypatch.setattr(_build, "stream", lambda dev: None)
    monkeypatch.setattr(eval_kernel.vae_dp_frame_eval, "launches",
                        eval_kernel.vae_dp_frame_eval.launches)
    return host_lib


def _frame(R, m_max, L, *, seed, mod="64-QAM", per_run=False, crop=None, noise=0.08, bf16=False):
    """One frame's eval inputs as kernel B leaves them: streams (m_max, R, ..., L)
    (with ``crop`` = (window, offset): views of wider windows; out, dec and eq
    bfloat16 with ``bf16``), tx (R, 2, 2, m_max L) levels, and the eval
    constants, shared or per run."""
    rng = np.random.default_rng(seed)
    n = m_max * L
    nus = (0.0, 0.0270955, 0.0872449)
    consts = [make_constellation(mod, nus[r % 3] if per_run else 0.0) for r in range(R)]
    c0 = consts[0]
    amps = torch.from_numpy(c0.amps)
    n_lev = amps.shape[0]
    idx = rng.integers(0, n_lev, size=(R, 2, 2, n))
    tx = amps[torch.from_numpy(idx)]
    # each equalizer pol b carries tx pol b ^ swap rolled by its shift, plus noise
    out = torch.empty((R, 2, 2, n))
    for r in range(R):
        s0, s1, swap = SHIFTS[r % len(SHIFTS)]
        for b, s in ((0, s0), (1, s1)):
            out[r, b] = torch.roll(tx[r, b ^ swap], s, dims=-1)
    out = (out * (1.0 + 0.05 * rng.normal())
           + noise * torch.from_numpy(rng.normal(size=out.shape))).to(torch.float32)
    snr = 23.0 - 3.0 * (np.arange(R) % 3 if per_run else np.zeros(R))
    var = torch.tensor([[demapper_noise_var(c, s)] * 2 for c, s in zip(consts, snr)],
                       dtype=torch.float32)
    nu_sc = torch.tensor([c.nu_sc for c in consts], dtype=torch.float32)
    # the softmin demapper's statistics and decisions at out (the kernel's
    # streams), a few decisions moved one level
    met = ((out[..., None, :] - amps[:, None]) ** 2 * (0.5 / var)[:, :, None, None, None]
           + nu_sc[:, None, None, None, None] * (amps * amps)[:, None])
    mm = met.min(dim=-2).values
    s1 = torch.exp(mm[..., None, :] - met).sum(dim=-2)
    dec = met.argmin(dim=-2).to(torch.int32)
    flip = torch.from_numpy(rng.random(size=dec.shape) < 0.02)
    dec = torch.where(flip, (dec + 1) % n_lev, dec)
    eq = out[:, :, 0] + 0.02 * torch.from_numpy(rng.normal(size=(R, 2, n))).to(torch.float32)

    def stream(a, narrow=False):  # (R, ..., n) -> (m_max, R, ..., L), or a crop of wider windows
        s = a.reshape(a.shape[:-1] + (m_max, L)).movedim(-2, 0)
        if narrow and bf16:
            s = s.to(torch.bfloat16)
        if crop is None:
            return s.contiguous()
        window, off = crop
        wide = torch.full(s.shape[:-1] + (window,), 7, dtype=s.dtype)
        wide[..., off : off + L] = s
        return wide[..., off : off + L]

    P = torch.from_numpy(np.stack([np.asarray(c.P, np.float32) for c in consts]))
    if per_run:
        rc = dict(P=P, var=var, nu_sc=nu_sc)
    else:
        rc = dict(P=P[0].contiguous(), var=var[0].contiguous(), nu_sc=c0.nu_sc)
    streams = (stream(out, True), stream(dec, True), stream(eq, True), stream(mm), stream(s1))
    return streams, tx, amps, rc


def _eval_case(R, m_max, L, *, seed, per_run=False, bf16=False, flex=False, noise=0.08):
    crop = (100, 45) if flex else None
    streams, tx, amps, rc = _frame(R, m_max, L, seed=seed, per_run=per_run, crop=crop, noise=noise,
                                   bf16=bf16)
    wfn = MarginWeight(m_max * L) if flex else BatchCutWeight(m_max, L, 10)
    args = (*streams, tx, amps, rc["P"], rc["nu_sc"], rc["var"], wfn)
    return args


def _check(got, want, ctx):
    names = ("ser_const", "ser_soft", "mi", "shift", "r")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, (ctx, name, g.shape, w.shape)
        if name == "mi":
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6, err_msg=f"{ctx} mi")
        else:
            assert torch.equal(g, w.to(g.dtype)), (ctx, name, g, w)


@pytest.mark.parametrize("case", [
    dict(R=1, m_max=30, L=100),
    dict(R=3, m_max=30, L=100),
    dict(R=8, m_max=12, L=100),
    dict(R=3, m_max=30, L=100, per_run=True),
    dict(R=8, m_max=12, L=100, per_run=True),
    dict(R=3, m_max=30, L=100, bf16=True),
    dict(R=8, m_max=12, L=100, per_run=True, bf16=True),
    dict(R=3, m_max=40, L=10, flex=True),
    dict(R=8, m_max=40, L=10, flex=True, per_run=True),
    dict(R=3, m_max=40, L=10, flex=True, bf16=True),
    dict(R=3, m_max=30, L=100, noise=0.3),
], ids=["vae_r1", "vae_r3", "vae_r8", "per_run_r3", "per_run_r8", "bf16_r3", "per_run_bf16_r8",
        "flex_r3", "flex_per_run_r8", "flex_bf16_r3", "noisy_r3"])
def test_eval_block_matches_plain(emulated, case):
    """K's clusters against ``_dp_frame_eval_mb`` on kernel B's stream layout:
    the VAE's batch-cut mask and VAEflex's crop with the margin mask, shared
    and per-run P / var / nu_sc, float32 and bfloat16 streams, R = 1, 3, 8,
    shifts across +-10 with both pol assignments."""
    args = _eval_case(**case, seed=11)
    got = eval_kernel._launch(*args)
    want = train_dp._dp_frame_eval_mb(*args)
    _check(got, want, case)
    shift, r = got[3], got[4]
    R = r.shape[0]
    assert r.tolist() == [SHIFTS[k % len(SHIFTS)][2] for k in range(R)]
    assert all(abs(s) <= 10 for s in shift.flatten().tolist())
    if "noise" not in case:  # the streams are aligned
        assert float(got[1].max()) < 0.5 and float(got[2].min()) > 0.0


def test_eval_runs_split_bit_for_bit(emulated):
    """R = 8 in one launch equals two launches of 4 runs (each run's cluster
    reads only its run), bit for bit."""
    args = _eval_case(8, 12, 100, seed=5, per_run=True)
    whole = eval_kernel._launch(*args)
    streams, (tx, amps, P, nu_sc, var, wfn) = args[:5], args[5:]
    halves = [eval_kernel._launch(*(s[:, sl] for s in streams), tx[sl], amps, P[sl], nu_sc[sl],
                                  var[sl], wfn)
              for sl in (slice(0, 4), slice(4, 8))]
    for k, w in enumerate(whole):
        assert torch.equal(w, torch.cat([h[k] for h in halves])), k


def test_eval_wrapper_refuses(emulated):
    """The public wrapper takes CUDA tensors only (the plain version serves
    the CPU); the launch refuses streams it cannot read in place."""
    args = _eval_case(2, 30, 100, seed=3)
    with pytest.raises(ValueError, match="CUDA"):
        eval_kernel.vae_dp_frame_eval(*args)
    out, dec, eq, mm, s1 = args[:5]
    with pytest.raises(ValueError, match="strides"):
        eval_kernel._launch(out, dec, eq, mm.transpose(0, 1).contiguous().transpose(0, 1),
                            s1, *args[5:])
    with pytest.raises(ValueError, match="streams"):
        eval_kernel._launch(out, dec.float(), eq, mm, s1, *args[5:])


def test_eval_block_repeats_and_clocks(emulated):
    """Two calls give the same bits; the clocks pointer changes no output
    (the host has no clock, so every phase keeps what it held)."""
    args = _eval_case(3, 30, 100, seed=9, bf16=True)
    a = eval_kernel._launch(*args)
    clocks = torch.ones(len(eval_kernel.CLOCK_PHASES), dtype=torch.int64)
    b = eval_kernel._launch(*args, clocks)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert clocks.tolist() == [1] * len(eval_kernel.CLOCK_PHASES)
