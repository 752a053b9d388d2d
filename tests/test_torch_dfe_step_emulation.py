"""Kernel J's CUDA block, compiled for the host.

``csrc/dfe_step.cuh`` compiles as plain C++ under ``VAE_HOST_EMULATION``
(``csrc/portable.cuh``), in which one thread runs every lane of the warp in
turn (each lane's points p = lane + 32 i and its first minimum) and closes
the lanes' minima with the card's xor butterfly of (distance, index) pairs.
``csrc/dfe_host_emulation.cpp`` wraps it in the dfe library's C launcher;
``ops/_build.py: host_library`` builds it with the host's C++ compiler; the
test patches ``ops/_build.py``'s ``load`` / ``stream`` to return it, and
runs the wrapper's own launch code (``ops/dfe_kernel.py: _launch``) on CPU
tensors against ``dfe_decide_plain``: the decisions must be equal bit for
bit, as chip_smoke.py's phase 27 holds them on the card. It skips where no
C++ compiler is found.
"""

import numpy as np
import pytest
import torch

import kernel_emulation
from vae_equalizer_tpu_torch.core import make_constellation
from vae_equalizer_tpu_torch.models import nearest_neighbor
from vae_equalizer_tpu_torch.ops import dfe_kernel as jk

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host_lib():
    return kernel_emulation.host_lib("dfe")


@pytest.fixture
def emulated(host_lib, monkeypatch):
    return kernel_emulation.emulate(monkeypatch, host_lib)


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


def _levels(points):
    """The grid's level sets (lx, ly) of a real-major L x L table."""
    L = round(points.shape[-1] ** 0.5)
    return points[0].reshape(L, L)[:, 0], points[1].reshape(L, L)[0]


def _tie_signal(points, rng, n):
    """A feedforward output whose values sit on exact float midpoints between
    adjacent levels of each axis, on grid corners (midpoints on both axes, a
    4-way tie), on the levels themselves, at and beyond the outer levels, and
    far outside the grid; shuffled, re / im drawn independently."""
    lx, ly = (v.numpy() for v in _levels(points))
    def axis(lv):
        mids = (lv[:-1] + lv[1:]) / np.float32(2)
        near = np.concatenate([mids + np.float32(2e-6), mids - np.float32(2e-6)])
        step = lv[1] - lv[0]
        far = np.array([lv[0] - step / 2, lv[-1] + step / 2, 3 * lv[0], 3 * lv[-1], -40.0, 40.0, 0.0],
                       dtype=np.float32)
        pool = np.concatenate([mids, mids, near, lv, far, far]).astype(np.float32)
        return pool[rng.integers(0, pool.size, n)]
    return torch.from_numpy(np.stack([axis(lx), axis(ly)]).astype(np.float32))


def _ties(ff, points):
    """How many symbols of ff (2, n) have two or more nearest points."""
    d = ((ff[:, :, None] - points[:, None, :]) ** 2).sum(0)
    return int(((d == d.min(-1, keepdim=True).values).sum(-1) > 1).sum())


def _rounded_row_ties(ff, points):
    """How many symbols of ff (2, n) have their nearest point (first index) in
    a row whose dx exceeds the smallest dx: the distances round together, and
    the grid route's columns must be found again with that row's dx."""
    lx, _ = _levels(points)
    d = ((ff[:, :, None] - points[:, None, :]) ** 2).sum(0)
    L = lx.numel()
    dx = (ff[0][:, None] - lx) ** 2
    ix = d.argmin(-1) // L
    return int((dx.gather(1, ix[:, None])[:, 0] != dx.min(-1).values).sum())


GRID_MODS = ["4-QAM", "16-QAM", "64-QAM", "256-QAM"]


@pytest.mark.parametrize("k2", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("mod", GRID_MODS)
def test_kernel_j_grid_route_ties(emulated, mod, k2):
    """The grid route (every QAM size, K2 = 0-4) against the plain loop, bit for
    bit: chain 0 sees exact midpoints, grid corners, the levels, values a few
    ulps off the midpoints and values beyond the outer levels with no
    feedback (so the ties reach the argmin as they are: the first index must
    win, also where a larger dx rounds to the smallest distance); chain 1 the
    same values through live feedback taps; chain 2 noise with live taps."""
    points = _points(mod)
    assert jk.dfe_route(points) == ("grid", round(points.shape[-1] ** 0.5))
    rng = np.random.default_rng(100 + k2)
    n = 700
    ff = torch.stack([_tie_signal(points, rng, n), _tie_signal(points, rng, n),
                      torch.from_numpy((0.8 * rng.normal(size=(2, n))).astype(np.float32))])
    assert _ties(ff[0], points) > n // 4
    if mod != "4-QAM":
        assert _rounded_row_ties(ff[0], points) > 0
    fb = torch.from_numpy((0.3 * rng.normal(size=(3, 2, k2))).astype(np.float32))
    fb[0] = 0.0
    init = nearest_neighbor(ff, points).contiguous()
    got = jk._launch(ff, fb, points, init)
    assert torch.equal(got, jk.dfe_decide_plain(ff, fb, points, init))


def _general_tables():
    """Tables that are no L x L real-major grid: a shuffled 64-QAM, 8-PSK, a
    16-QAM with one point moved by one ulp, and a 3 x 3 grid (L not a power
    of two)."""
    rng = np.random.default_rng(7)
    q64 = _points("64-QAM")
    ang = np.arange(8) * np.pi / 4
    moved = _points("16-QAM").clone()
    moved[0, 5] = float(np.nextafter(moved[0, 5].numpy(), np.float32(1.0)))
    lv = np.array([-1.0, 0.0, 1.0], dtype=np.float32)
    return {"shuffled_64qam": q64[:, torch.from_numpy(rng.permutation(64))].contiguous(),
            "8psk": torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)),
            "16qam_one_ulp": moved,
            "3x3": torch.from_numpy(np.stack([np.repeat(lv, 3), np.tile(lv, 3)]))}


@pytest.mark.parametrize("table", list(_general_tables()))
def test_kernel_j_general_route(emulated, table):
    """A table that is not a grid takes the general route (one warp per chain,
    the butterfly), bit for bit with the plain loop, ties included."""
    points = _general_tables()[table]
    assert jk.dfe_route(points) == ("general", 0)
    rng = np.random.default_rng(3)
    ff = torch.from_numpy((0.8 * rng.normal(size=(3, 2, 900))).astype(np.float32))
    ff[1, :, 200:260] = 0.0
    fb = torch.from_numpy((0.3 * rng.normal(size=(3, 2, 3))).astype(np.float32))
    fb[1] = 0.0
    init = nearest_neighbor(ff, points).contiguous()
    got = jk._launch(ff, fb, points, init)
    assert torch.equal(got, jk.dfe_decide_plain(ff, fb, points, init))


def test_dfe_route_needs_an_exact_finite_grid():
    """Every QAM table is a grid; the same points imaginary-major (the planes
    swapped), a non-finite level and a table of 2 x 8 points are not."""
    for mod in GRID_MODS:
        pts = _points(mod)
        assert jk.dfe_route(pts) == ("grid", round(pts.shape[-1] ** 0.5))
    assert jk.dfe_route(_points("16-QAM")[[1, 0]].contiguous()) == ("general", 0)
    bad = _points("4-QAM").clone()
    bad[0, 0] = float("inf")
    assert jk.dfe_route(bad) == ("general", 0)
    assert jk.dfe_route(_points("16-QAM")[:, :8].contiguous()) == ("general", 0)


@pytest.mark.parametrize("table", ["grid", "general"])
def test_kernel_j_clocks_change_nothing(emulated, table):
    """The clocks pointer changes no decision on either route (the host has no
    clock, so every phase reads 0 there)."""
    points = _points("64-QAM") if table == "grid" else _general_tables()["8psk"]
    rng = np.random.default_rng(9)
    ff = torch.from_numpy((0.7 * rng.normal(size=(2, 2, 800))).astype(np.float32))
    fb = torch.from_numpy((0.3 * rng.normal(size=(2, 2, 4))).astype(np.float32))
    init = nearest_neighbor(ff, points).contiguous()
    clocks = torch.ones(len(jk.J_CLOCK_PHASES), dtype=torch.int64)
    assert torch.equal(jk._launch(ff, fb, points, init, clocks), jk._launch(ff, fb, points, init))
    assert clocks.tolist() == [0] * len(jk.J_CLOCK_PHASES)


def test_kernel_j_grid_route_reruns_the_columns(emulated):
    """A 2 x 2 grid where the first nearest point lies in the row of the larger
    dx (its distance rounds to the smallest): at ik = 0, dx = (a0^2, a1^2)
    with a0^2 two ulps above a1^2, and the columns' distances rounded with
    min dx pick column 0 while with row 0's dx only column 1 is nearest.
    The plain version decides point 1 there; the grid route must too."""
    a0, a1 = 0.30000007152557373, 0.30000004172325134
    b0, b1 = 0.3000001311302185, 0.3000001013278961
    points = torch.tensor([[a0, a0, a1, a1], [b0, b1, b0, b1]], dtype=torch.float32)
    assert jk.dfe_route(points) == ("grid", 2)
    ff = torch.zeros((2, 2, 50))
    ff[1, :, 25:] = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 25)).astype(np.float32))
    for k2 in (0, 2):
        fb = torch.zeros((2, 2, k2))
        init = nearest_neighbor(ff, points).contiguous()
        want = jk.dfe_decide_plain(ff, fb, points, init)
        assert int(want[0, -1]) == 1
        assert torch.equal(jk._launch(ff, fb, points, init), want)
