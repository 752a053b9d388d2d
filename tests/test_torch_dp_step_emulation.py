"""Kernels A and B's CUDA step body, compiled for the host.

``csrc/dp_step.cuh`` compiles as plain C++ under ``VAE_HOST_EMULATION``
(``csrc/portable.cuh``), in which one "thread" runs every item of every
phase (a warp of one lane; barriers are no-ops).
``csrc/dp_host_emulation.cpp`` wraps it in the dp library's C launchers;
``ops/_build.py: host_library`` builds it with the host's C++ compiler; the
test patches ``ops/_build.py``'s ``load`` / ``stream`` to return it, and
runs the wrappers' own launch code (``ops/frame_kernel.py: _launch``,
``ops/elbo_kernel.py: _launch``) on CPU tensors against the plain versions,
at the tolerances of chip_smoke.py's phases 4a (kernel B, a few minibatches
across the lr halving) and 3 (kernel A); the plain versions run in float64
at 64-QAM (``_ref``). It is the CPU's only check of the body's index
arithmetic; the card runs the same source (``tests/ test_torch_cuda.py``,
``chip_smoke.py``). The body's two instances (8 levels, generic) are held to
each other bit for bit, its branch-free divisions to IEEE division, and the
wrappers' launch counts by instance checked. It skips where no C++ compiler
is found.
"""

import ctypes
import types

import numpy as np
import pytest
import torch

import chip_smoke
import kernel_emulation
from vae_equalizer_tpu_torch.core import demapper_noise_var, make_constellation
from vae_equalizer_tpu_torch.models import butterfly_init, dirac_taps_dp
from vae_equalizer_tpu_torch.ops import _build, elbo_kernel, frame_kernel
from vae_equalizer_tpu_torch.train import dp as train_dp
from vae_equalizer_tpu_torch.utils import DpConfig

torch.set_num_threads(1)

STEP0, LR_HALF = 40, 41.0  # the w lr halves at the second minibatch


@pytest.fixture(scope="module")
def host_lib():
    """The emulated dp library, with its generic instances' entry points typed."""
    lib = kernel_emulation.host_lib("dp")
    for fn_name, argtypes in _build._SIGNATURES["dp"].items():
        fn = getattr(lib, fn_name + "_generic")
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


@pytest.fixture
def emulated(host_lib, monkeypatch):
    return kernel_emulation.emulate(monkeypatch, host_lib)


def _inputs(mod, bl, m, R, n_samp, seed, per_run=False):
    """Perturbed-Dirac taps, R runs of the DP channel (DpConfig()'s: 23 dB,
    CD / PMD, theta = pi/10; ``mod``), ``n_samp`` samples each, and the run
    constants: shared, or per run (nu 0.0270955 / 0 / 0.0872449 at 16 / 20 /
    23 dB, as chip_smoke's phase 21)."""
    cfg = DpConfig(mod=mod, m_est=m, batch_len=bl)
    const, var, sim, amps, P = train_dp._setup(cfg, n_samp // 2, "cpu")
    rx = sim(torch.Generator().manual_seed(seed), float(np.float32(cfg.theta)), R)[0].contiguous()
    rng = np.random.default_rng(seed)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    w = T(butterfly_init(m).numpy() + 0.01 * rng.normal(size=(R, 2, 4, m)))
    h = T(dirac_taps_dp(m).numpy() + 0.01 * rng.normal(size=(R, 2, 2, 2, m)))
    if not per_run:
        return amps, w, h, rx, dict(lr=cfg.lr, nu_sc=const.nu_sc, P=P, var=var)
    consts = [make_constellation(mod, nu) for nu in (0.0270955, 0.0, 0.0872449)[:R]]
    snrs = (16.0, 20.0, 23.0)
    return amps, w, h, rx, dict(
        lr=T([2.5e-3, 1e-3, 3e-3][:R]), nu_sc=T([k.nu_sc for k in consts]),
        var=T([[demapper_noise_var(k, s)] * 2 for k, s in zip(consts, snrs)]),
        P=T(np.stack([k.P for k in consts])))


def _ref(args, dtype):
    """The plain version's inputs in ``dtype``. At 64-QAM the reference is
    float64: in float32 on the CPU the plain version's own rounding (einsum
    orders, no fused multiply-add), amplified by the demapper's 1 / (2 var)
    gain and by Adam, is about as large as phase 4a's tolerances (the moments
    up to 1.5x them at the flagship shapes), and the kernel's sums are closer
    to exact. At 4-QAM and 23 dB the softmin saturates (exp underflows in
    float32 where float64 keeps tiny posteriors), so float32 semantics decide
    and the reference is float32."""
    return [a.to(dtype) if torch.is_tensor(a) else
            {k: v.to(dtype) for k, v in a.items()} if isinstance(a, dict) else a for a in args]


def _frame_case(mod, bl, m, R, n_mb, stride_sym=None, per_run=False, seed=3):
    ref = torch.float32
    # (n_total / 2 - bl) // stride_sym windows with a stride, n_total / (2 bl) without
    n_samp = 2 * (stride_sym * n_mb + bl) if stride_sym else 2 * bl * n_mb
    amps, w, h, rx, c = _inputs(mod, bl, m, R, n_samp, seed, per_run)
    args = (w, h, frame_kernel.frame_opt_init({"w": w, "h": h}), rx, amps, c["var"], c["nu_sc"],
            c["P"], c["lr"], STEP0, LR_HALF)
    got = frame_kernel._launch(*args, bl, stride_sym, False)
    want = frame_kernel.vae_dp_frame_train_plain(*_ref(args, ref), bl_sym=bl, stride_sym=stride_sym)
    assert got[3].shape == (n_mb, R)
    errs: dict = {}
    chip_smoke._check_b3(got, want, amps, c["var"], c["nu_sc"], 1e-5 if per_run else 1e-6, errs)


@pytest.mark.parametrize("case", [
    dict(mod="64-QAM", bl=100, m=25, R=2, n_mb=3),
    dict(mod="64-QAM", bl=100, m=25, R=2, n_mb=3, stride_sym=10),
    dict(mod="64-QAM", bl=100, m=25, R=3, n_mb=3, per_run=True),
    dict(mod="4-QAM", bl=16, m=9, R=2, n_mb=3),
    dict(mod="16-QAM", bl=100, m=25, R=2, n_mb=3),
    dict(mod="256-QAM", bl=100, m=25, R=2, n_mb=3),
], ids=["flagship", "stride10", "per_run", "4qam_bl16", "16qam", "256qam"])
def test_frame_block_matches_plain(emulated, case):
    """Kernel B's block (3 minibatches across the w lr halving) against
    ``vae_dp_frame_train_plain`` at phase 4a's tolerances."""
    _frame_case(**case)


@pytest.mark.parametrize("mod,bl,m", [("64-QAM", 100, 25), ("4-QAM", 16, 9)])
def test_step_block_matches_plain(emulated, mod, bl, m):
    """Kernel A's block, R = 2 windows of a longer frame read in place,
    against ``vae_dp_loss_and_grad_plain`` at phase 3's tolerances."""
    amps, w, h, rx, c = _inputs(mod, bl, m, 2, 8 * bl, seed=5)
    x = rx[..., 2 * bl : 4 * bl]
    args = (w, h, x, amps, c["var"], c["nu_sc"], c["P"])
    got = elbo_kernel._launch(*args)
    want = elbo_kernel.vae_dp_loss_and_grad_plain(
        *_ref(args, torch.float32))
    errs: dict = {}
    for name, g, wt in zip(("loss", "var_est", "gw", "gh", "q", "out"), got, want):
        chip_smoke._check(name, g, wt, 1e-4, 1e-4 * float(wt.abs().max()), errs)


def test_frame_block_repeats_and_clocks(emulated):
    """Two calls give the same bits; the clocks pointer changes no output
    (the host has no clock, so every phase reads 0 there)."""
    amps, w, h, rx, c = _inputs("64-QAM", 100, 25, 2, 600, seed=9)
    args = (w, h, frame_kernel.frame_opt_init({"w": w, "h": h}), rx, amps, c["var"], c["nu_sc"],
            c["P"], c["lr"], STEP0, LR_HALF)
    a = frame_kernel._launch(*args, 100, None, False)
    clocks = torch.ones(len(frame_kernel.CLOCK_PHASES), dtype=torch.int64)
    b = frame_kernel._launch(*args, 100, None, False, clocks)
    for x, y in zip(a, b):
        for u, v in (zip(x.values(), y.values()) if isinstance(x, dict) else ((x, y),)):
            assert torch.equal(u, v)
    assert clocks.tolist() == [0] * len(frame_kernel.CLOCK_PHASES)


@pytest.fixture
def generic(host_lib, monkeypatch):
    """The emulated dp library with every launch in the generic instance."""
    lib = types.SimpleNamespace(vae_dp_step_launch=host_lib.vae_dp_step_launch_generic,
                                vae_dp_frame_launch=host_lib.vae_dp_frame_launch_generic)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda dev: None)
    return lib


def _flat(res) -> list:
    return [t for x in res for t in (x.values() if isinstance(x, dict) else (x,))]


@pytest.mark.parametrize("case", [dict(stride_sym=None, bf16=False), dict(stride_sym=10, bf16=True)],
                         ids=["frame", "stride10_bf16"])
def test_nlev8_instance_is_generic_instance(host_lib, monkeypatch, case):
    """On the same 64-QAM inputs the 8-level instance of kernels A and B and
    the generic one give the same bits (every output, across the lr halving)."""
    amps, w, h, rx, c = _inputs("64-QAM", 100, 25, 2, 2 * 100 * 4, seed=13)
    args = (w, h, frame_kernel.frame_opt_init({"w": w, "h": h}), rx, amps, c["var"], c["nu_sc"],
            c["P"], c["lr"], STEP0, LR_HALF)
    x = rx[..., 200:400]
    a_args = (w, h, x, amps, c["var"], c["nu_sc"], c["P"])
    got = {}
    monkeypatch.setattr(_build, "stream", lambda dev: None)
    for name, lib in (("nlev8", host_lib), ("generic", types.SimpleNamespace(
            vae_dp_step_launch=host_lib.vae_dp_step_launch_generic,
            vae_dp_frame_launch=host_lib.vae_dp_frame_launch_generic))):
        monkeypatch.setattr(_build, "load", lambda lib=lib: lib)
        got[name] = (_flat(frame_kernel._launch(*args, 100, case["stride_sym"], case["bf16"]))
                     + list(elbo_kernel._launch(*a_args)))
    assert len(got["nlev8"]) == 19
    for a, b in zip(got["nlev8"], got["generic"]):
        assert torch.equal(a, b)


def test_launches_counted_by_instance(emulated, monkeypatch):
    """Kernels A and B count every launch in ``launches``, whichever instance
    runs it: 8 levels at 64-QAM (the flagship), the generic one at 4-QAM."""
    for wrapper in (frame_kernel.vae_dp_frame_train, elbo_kernel.vae_dp_loss_and_grad):
        monkeypatch.setattr(wrapper, "launches", 0)
    for mod, bl, m in (("64-QAM", 100, 25), ("4-QAM", 16, 9), ("64-QAM", 100, 25)):
        amps, w, h, rx, c = _inputs(mod, bl, m, 1, 2 * bl * 2, seed=1)
        frame_kernel._launch(w, h, frame_kernel.frame_opt_init({"w": w, "h": h}), rx, amps, c["var"],
                             c["nu_sc"], c["P"], c["lr"], 0, 1e9, bl, None, False)
        elbo_kernel._launch(w, h, rx[..., : 2 * bl], amps, c["var"], c["nu_sc"], c["P"])
    for wrapper in (frame_kernel.vae_dp_frame_train, elbo_kernel.vae_dp_loss_and_grad):
        assert wrapper.launches == 3


def test_launch_counts_replayed_by_instance(monkeypatch):
    """A graph's captured launches (``_build.launches_since``) add to
    ``launches`` at each replay (``add_launches``), and ``set_launch_state``
    puts the counts back."""
    wrapper = frame_kernel.vae_dp_frame_train
    monkeypatch.setattr(wrapper, "launches", 5)
    before = _build.launch_state()
    _build.count_launch(wrapper)
    _build.count_launch(wrapper)
    added = _build.launches_since(before)
    assert added == {wrapper: 2}
    _build.set_launch_state(before)
    assert wrapper.launches == 5
    _build.add_launches(added)
    _build.add_launches(added)
    assert wrapper.launches == 9


def test_division_forms_are_ieee_division(host_lib):
    """The step's branch-free divisions give the IEEE float quotient on 10^7
    draws of each of the demapper's and dL/dout's divisions over their
    operand ranges, zero and denormal dividends included: Markstein's metric
    (mdiv), and fdiv with recip's reciprocal moved by up to 4 double ulps
    either way (``csrc/dp_host_emulation.cpp: vae_dp_division_check``)."""
    check = host_lib.vae_dp_division_check
    check.argtypes, check.restype = [ctypes.c_longlong, ctypes.c_ulonglong], ctypes.c_longlong
    assert check(10_000_000, 20261018) == 0
