"""Kernels C, D and I's CUDA blocks, compiled for the host.

``csrc/cma_step.cuh`` compiles as plain C++ under ``VAE_HOST_EMULATION``
(``csrc/portable.cuh``), in which one thread runs every item of every phase
and computes each item's lane partials one after another, closing them with
the card's xor butterfly, so the card's lane partition and summation order
are reproduced (barriers are no-ops, cp.async a copy).
``csrc/cma_host_emulation.cpp`` wraps it in the cma library's C launchers;
``ops/_build.py: host_library`` builds it with the host's C++ compiler; the
test patches ``ops/_build.py``'s ``load`` / ``stream`` to return it, and
runs the wrappers' own launch code (``ops/cma_kernel.py: _launch``,
``ops/cma_frame_kernel.py: _launch``, ``ops/cma_siso_kernel.py: _launch``)
on CPU tensors against ``cma_dp_plain`` / ``cma_chunked_frame_plain`` /
``cma_siso_experiment_plain`` at chip_smoke.py's phase 7 / 8 / 25 tolerances
(rtol 1e-4 over 1e-6 of each tensor's scale). It is the CPU's only check of
the blocks' index arithmetic (tiles, the o / e ring, the rolled storage, the
prefix and the tail; I's per-epoch window restart, its frame edges and eval
slots); the card runs the same source (``tests/test_torch_cma_kernels.py``,
``tests/test_torch_cma_awgn.py``, ``chip_smoke.py``). It skips where no C++
compiler is found.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import kernel_emulation
from vae_equalizer_tpu_torch.models import dirac_taps_dp, dirac_taps_siso
from vae_equalizer_tpu_torch.models.cma import chunk_schedule
from vae_equalizer_tpu_torch.ops import cma_frame_kernel as cfk
from vae_equalizer_tpu_torch.ops import cma_kernel as ck
from vae_equalizer_tpu_torch.ops import cma_siso_kernel as ik

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host_lib():
    return kernel_emulation.host_lib("cma")


@pytest.fixture
def emulated(host_lib, monkeypatch):
    return kernel_emulation.emulate(monkeypatch, host_lib)


def _frame(R, n_sym, m=25, sps=2, seed=11):
    """R runs of Gaussian samples and a perturbed Dirac start (numpy seed)."""
    rng = np.random.default_rng(seed)
    rx = torch.from_numpy(rng.normal(size=(R, 2, 2, n_sym * sps)).astype(np.float32))
    h0 = dirac_taps_dp(m) + torch.from_numpy((0.01 * rng.normal(size=(R, 2, 2, 2, m))).astype(np.float32))
    return rx, h0.contiguous()


def _close(got, want):
    """Phase 7 / 8's tolerances: rtol 1e-4 over 1e-6 of each tensor's scale."""
    errs: dict = {}
    for name, g, w in zip(("out", "h", "e"), got, want):
        assert g.shape == w.shape, name
        chip_smoke._check(name, g, w, 1e-4, 1e-6 * float(w.abs().max()), errs)
    return errs


C_CASES = {
    "m25_update": dict(m=25, sps=2, update=True),
    "m25_frozen": dict(m=25, sps=2, update=False),
    "m41_update": dict(m=41, sps=2, update=True),  # two taps per lane
    "m9_sps1": dict(m=9, sps=1, update=True),
}


@pytest.mark.parametrize("case", list(C_CASES), ids=list(C_CASES))
def test_kernel_c_block_matches_plain(emulated, case):
    """Kernel C's block over 1,206 symbols (R = 2, a staged tile boundary every
    64) against the per-symbol plain loop."""
    c = C_CASES[case]
    rx, h0 = _frame(2, 1206, c["m"], c["sps"])
    args = (rx, 1.0, h0, 1e-3, c["sps"], c["update"])
    _close(ck._launch(*args), ck.cma_dp_plain(*args))


D_CASES = [(100, 100), (100, 10), (60, 20)]


@pytest.mark.parametrize("n_sym", [1207, 1206], ids=["tail1", "tailS"])
@pytest.mark.parametrize("B,S", D_CASES, ids=[f"B{b}_S{s}" for b, s in D_CASES])
def test_kernel_d_block_matches_plain(emulated, B, S, n_sym):
    """Kernel D's whole frame (prefix, chunks, tail) against the chunked plain
    engine; 1,207 symbols leave a tail of 1 and 1,206 a tail of S at M = 25,
    sps 2 for all three (B, S)."""
    rx, h0 = _frame(2, n_sym)
    assert chunk_schedule(n_sym, B, S, 12, 2)[2] == (1 if n_sym == 1207 else S)
    args = (rx, 1.0, h0, 1e-4, B, S, 2)
    _close(cfk._launch(*args), cfk.cma_chunked_frame_plain(*args))


def test_kernel_d_block_other_shapes(emulated):
    """M = 41 (eight taps per lane in the outputs), sps 1, a short frame with no
    full chunk (n_full = 0), a ring of 40 slots and chunks of one symbol (a
    prefix of 6 output-only stages)."""
    for m, sps, n_sym, B, S in ((41, 2, 900, 100, 20), (9, 1, 700, 40, 8), (25, 2, 112, 100, 10),
                                (25, 2, 1206, 400, 10), (25, 2, 500, 30, 1)):
        rx, h0 = _frame(2, n_sym, m, sps, seed=m)
        args = (rx, 1.0, h0, 1e-4, B, S, sps)
        if n_sym == 112:
            assert chunk_schedule(n_sym, B, S, m // 2, sps)[1] == 0
        _close(cfk._launch(*args), cfk.cma_chunked_frame_plain(*args))


@pytest.mark.parametrize("kernel", ["C", "D_flex", "D_batch"])
def test_runs_are_single_run_calls_and_repeat(emulated, kernel):
    """R = 3 in one call equals three single-run calls bit for bit; two calls
    give the same bits; the clocks pointer changes no output (the host has no
    clock, so every phase reads 0 there)."""
    rx, h0 = _frame(3, 1206)
    launch, phases = {
        "C": (lambda x, h, **kw: ck._launch(x, 1.0, h, 1e-3, 2, True, **kw), ck.C_CLOCK_PHASES),
        "D_flex": (lambda x, h, **kw: cfk._launch(x, 1.0, h, 1e-4, 100, 10, 2, **kw), cfk.D_CLOCK_PHASES),
        "D_batch": (lambda x, h, **kw: cfk._launch(x, 1.0, h, 1e-4, 100, 100, 2, **kw), cfk.D_CLOCK_PHASES),
    }[kernel]
    full = launch(rx, h0)
    for r in range(3):
        one = launch(rx[r : r + 1].contiguous(), h0[r : r + 1].contiguous())
        for a, b in zip(one, full):
            assert torch.equal(a[0], b[r])
    clocks = torch.ones(len(phases), dtype=torch.int64)
    again = launch(rx, h0, clocks=clocks)
    for a, b in zip(again, full):
        assert torch.equal(a, b)
    assert clocks.tolist() == [0] * len(phases)


def _epochs(R, E, n_sym, m=25, sps=2, seed=21):
    """R runs of E Gaussian frames and a perturbed Dirac SISO start (numpy seed)."""
    rng = np.random.default_rng(seed)
    rx = torch.from_numpy((0.7 * rng.normal(size=(R, E, 2, n_sym * sps))).astype(np.float32))
    h0 = dirac_taps_siso(m) + torch.from_numpy((0.01 * rng.normal(size=(R, 2, m))).astype(np.float32))
    return rx, h0.contiguous()


I_CASES = {
    "m25_epe2": dict(m=25, sps=2, E=5, epe=2),  # epoch 4 trains without an eval slot
    "m41_epe1": dict(m=41, sps=2, E=3, epe=1),  # two taps per lane
    "m9_sps1": dict(m=9, sps=1, E=4, epe=3),
    "m24_even": dict(m=24, sps=2, E=2, epe=1),
}


@pytest.mark.parametrize("case", list(I_CASES), ids=list(I_CASES))
def test_kernel_i_block_matches_plain(emulated, case):
    """Kernel I's whole experiment (R = 2, 600 symbols an epoch) against the
    per-epoch plain loop: final taps, eval slots and per-epoch mean |e|."""
    c = I_CASES[case]
    rx, h0 = _epochs(2, c["E"], 600, c["m"], c["sps"])
    args = (rx, h0, 1.0, 1e-3, c["sps"], c["epe"])
    got, want = ik._launch(*args), ik.cma_siso_experiment_plain(*args)
    errs: dict = {}
    for name, g, w in zip(("h", "h_ev", "loss"), got, want):
        assert g.shape == w.shape, name
        chip_smoke._check(name, g, w, 1e-4, 1e-6 * float(w.abs().max()), errs)


def test_kernel_i_runs_are_single_run_calls_and_repeat(emulated):
    """R = 3 in one call equals three single-run calls bit for bit; two calls
    give the same bits; the clocks pointer changes no output."""
    rx, h0 = _epochs(3, 3, 500)
    full = ik._launch(rx, h0, 1.0, 1e-3, 2, 1)
    for r in range(3):
        h, h_ev, loss = ik._launch(rx[r : r + 1].contiguous(), h0[r : r + 1].contiguous(), 1.0,
                                   1e-3, 2, 1)
        assert torch.equal(h[0], full[0][r]) and torch.equal(h_ev[:, 0], full[1][:, r])
        assert torch.equal(loss[0], full[2][r])
    clocks = torch.ones(len(ik.I_CLOCK_PHASES), dtype=torch.int64)
    again = ik._launch(rx, h0, 1.0, 1e-3, 2, 1, clocks)
    assert all(torch.equal(a, b) for a, b in zip(again, full))
    assert clocks.tolist() == [0] * len(ik.I_CLOCK_PHASES)


I_GROUP_CASES = {  # the group's lane partition at M up to 64, sps 1 and 2, R past one warp's runs
    "m64_sps2": dict(m=64, sps=2, E=3, epe=1, R=2),  # eight taps per lane
    "m33_sps1": dict(m=33, sps=1, E=3, epe=2, R=3),
    "m25_sps1_R5": dict(m=25, sps=1, E=4, epe=2, R=5),  # 4 runs a warp on one SM: 4 + 1
    "m48_sps2_R7": dict(m=48, sps=2, E=2, epe=1, R=7),
    "m25_long": dict(m=25, sps=2, E=2, epe=1, R=2, n_sym=2600),  # the frame wraps the staging ring twice
    "m64_sps1_long": dict(m=64, sps=1, E=1, epe=1, R=3, n_sym=2600),
}


@pytest.mark.parametrize("case", list(I_GROUP_CASES), ids=list(I_GROUP_CASES))
def test_kernel_i_group_partition_matches_plain(emulated, case):
    """Kernel I's lane groups (the emulation packs runs into warps as a card of
    one SM would, so R = 5 and 7 leave a warp with groups past the last run)
    against the per-epoch plain loop at phase 25's tolerances; the long
    frames wrap the shared-memory staging ring (4 chunks of 512 samples)."""
    c = I_GROUP_CASES[case]
    rx, h0 = _epochs(c["R"], c["E"], c.get("n_sym", 500), c["m"], c["sps"], seed=c["m"])
    args = (rx, h0, 1.0, 1e-3, c["sps"], c["epe"])
    got, want = ik._launch(*args), ik.cma_siso_experiment_plain(*args)
    errs: dict = {}
    for name, g, w in zip(("h", "h_ev", "loss"), got, want):
        assert g.shape == w.shape, name
        chip_smoke._check(name, g, w, 1e-4, 1e-6 * float(w.abs().max()), errs)


def test_kernel_i_packed_runs_are_single_run_calls(emulated):
    """R = 5 packed 4 + 1 into warps equals five single-run calls bit for bit,
    frames shorter than the window included (every symbol bounds-checked)."""
    for n_sym, m in ((400, 25), (10, 41)):
        rx, h0 = _epochs(5, 2, n_sym, m)
        full = ik._launch(rx, h0, 1.0, 1e-3, 2, 1)
        for r in range(5):
            h, h_ev, loss = ik._launch(rx[r : r + 1].contiguous(), h0[r : r + 1].contiguous(), 1.0,
                                       1e-3, 2, 1)
            assert torch.equal(h[0], full[0][r]) and torch.equal(h_ev[:, 0], full[1][:, r])
            assert torch.equal(loss[0], full[2][r])
        want = ik.cma_siso_experiment_plain(rx, h0, 1.0, 1e-3, 2, 1)
        errs: dict = {}
        for name, g, w in zip(("h", "h_ev", "loss"), full, want):
            chip_smoke._check(name, g, w, 1e-4, 1e-6 * float(w.abs().max()), errs)
