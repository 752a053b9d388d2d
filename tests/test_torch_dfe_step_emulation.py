"""Kernel J's CUDA block, compiled for the host.

``csrc/dfe_step.cuh`` compiles as plain C++ under ``DFE_HOST_EMULATION``, in
which one thread runs every lane of the warp in turn (each lane's points
p = lane + 32 i and its first minimum) and closes the lanes' minima with the
card's xor butterfly of (distance, index) pairs. ``csrc/dfe_host_emulation.cpp``
wraps it in the dfe library's C launcher; the test builds it with the host's
C++ compiler (``-ffp-contract=off``, as ``--fmad=false`` on the card),
patches ``ops/_build.py``'s ``load`` / ``stream`` to return it, and runs the
wrapper's own launch code (``ops/dfe_kernel.py: _launch``) on CPU tensors
against ``dfe_decide_plain``: the decisions must be equal bit for bit, as
chip_smoke.py's phase 27 holds them on the card. It skips where no C++
compiler is found.
"""

import ctypes
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from vae_equalizer_tpu_torch.core import make_constellation
from vae_equalizer_tpu_torch.models import nearest_neighbor
from vae_equalizer_tpu_torch.ops import _build
from vae_equalizer_tpu_torch.ops import dfe_kernel as jk

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The emulated dfe library's typed entry point, built once."""
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler found to build csrc/dfe_host_emulation.cpp")
    so = tmp_path_factory.mktemp("dfe_host") / "libdfe_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    "-DDFE_HOST_EMULATION", "-o", str(so), str(_build.CSRC / "dfe_host_emulation.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    fns = {}
    for name, argtypes in _build._SIGNATURES["dfe"].items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return types.SimpleNamespace(lib=lib, **fns)


@pytest.fixture
def emulated(host_lib, monkeypatch):
    """The emulated library in place of the card's; the wrapper's launch count
    is restored afterwards."""
    monkeypatch.setattr(_build, "load", lambda: host_lib)
    monkeypatch.setattr(_build, "stream", lambda dev: None)
    monkeypatch.setattr(jk.dfe_decide, "launches", jk.dfe_decide.launches)
    return host_lib


def _points(mod):
    c = make_constellation(mod, 0.0)
    return torch.from_numpy(np.stack([c.points.real, c.points.imag]).astype(np.float32))


CASES = {  # feedback taps, constellation
    "k4_64qam": (4, "64-QAM"),
    "k3_16qam": (3, "16-QAM"),
    "k0_4qam": (0, "4-QAM"),
    "k4_256qam": (4, "256-QAM"),
    "k1_64qam": (1, "64-QAM"),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_kernel_j_block_matches_plain(emulated, case):
    """B = 4 chains of 2,000 symbols, noisy enough that the feedback state
    matters and ties of the argmin are reached (a zero signal ties every
    distance of a symmetric constellation)."""
    k2, mod = CASES[case]
    rng = np.random.default_rng(k2)
    points = _points(mod)
    ff = torch.from_numpy((0.8 * rng.normal(size=(4, 2, 2000))).astype(np.float32))
    ff[1, :, 100:140] = 0.0  # ties: the first index must win
    fb = torch.from_numpy((0.3 * rng.normal(size=(4, 2, k2))).astype(np.float32))
    if k2:
        fb[1, :, :] = 0.0
    init = nearest_neighbor(ff, points).contiguous()
    got = jk._launch(ff, fb, points, init)
    assert got.dtype == torch.int32 and got.shape == (4, 2000)
    assert torch.equal(got, jk.dfe_decide_plain(ff, fb, points, init))
    assert torch.equal(got[:, :k2], init[:, :k2])
    assert jk.dfe_decide.launches >= 1


def test_kernel_j_chains_are_single_calls(emulated):
    """Four chains in one call equal four single-chain calls."""
    rng = np.random.default_rng(5)
    points = _points("64-QAM")
    ff = torch.from_numpy((0.7 * rng.normal(size=(4, 2, 1500))).astype(np.float32))
    fb = torch.from_numpy((0.3 * rng.normal(size=(4, 2, 4))).astype(np.float32))
    init = nearest_neighbor(ff, points).contiguous()
    full = jk._launch(ff, fb, points, init)
    for b in range(4):
        one = jk._launch(ff[b : b + 1].contiguous(), fb[b : b + 1].contiguous(), points,
                         init[b : b + 1].contiguous())
        assert torch.equal(one[0], full[b])
    with pytest.raises(ValueError, match="at most 4 feedback taps"):
        jk._launch(ff, torch.zeros((4, 2, 5)), points, init)
