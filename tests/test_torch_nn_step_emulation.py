"""Kernel H's CUDA block, compiled for the host.

``csrc/nn_step.cuh`` compiles as plain C++ under ``VAE_HOST_EMULATION``
(``csrc/portable.cuh``), in which one "thread" runs every item of every
phase (a warp of one lane; barriers are no-ops).
``csrc/nn_host_emulation.cpp`` wraps it in the nn library's C launcher;
``ops/_build.py: host_library`` builds it with the host's C++ compiler; the
test patches ``ops/_build.py``'s ``load`` / ``stream`` to return it, and
runs the wrapper's own launch code (``ops/nn_frame_kernel.py: _launch``) on
CPU tensors against ``vae_nn_experiment_train_plain``, for Net and Net_BN,
at chip_smoke.py's phase 13a tolerances (losses rtol 1e-4; parameters,
running statistics and eval slots rtol 1e-3 over a 1e-5 floor). It is the
CPU's only check of the block's index arithmetic (tiles, sample planes,
split sums); the card runs the same source
(``tests/test_torch_nn_kernel.py``, ``chip_smoke.py``). The split sums'
chunks are those of the card's 512 threads, so the emulation runs the same
chunking. It skips where no C++ compiler is found.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import kernel_emulation
from vae_equalizer_tpu_torch.core import make_constellation
from vae_equalizer_tpu_torch.ops import nn_frame_kernel as nfk

torch.set_num_threads(1)

NAMES = ("w1f", "w2f", "h", "bnp", "rs")
SLOTS = ((7, "w1_ev"), (8, "w2_ev"), (9, "h_ev"), (10, "bnp_ev"), (11, "rs_ev"))


@pytest.fixture(scope="module")
def host_lib():
    return kernel_emulation.host_lib("nn")


@pytest.fixture
def emulated(host_lib, monkeypatch):
    return kernel_emulation.emulate(monkeypatch, host_lib)


def _inputs(mod, m, k1, bl, nb, epochs, R, batchnorm, seed=23):
    """Perturbed Xavier-scale weights, a perturbed Dirac h, for Net_BN a
    non-trivial (gamma | beta) and unit running statistics, and R runs of
    ``epochs`` rows of nb minibatches of Gaussian samples (numpy seed)."""
    if isinstance(mod, int):  # n_lev equally spaced levels of unit power (C = 2 n_lev)
        lev = np.linspace(-1.0, 1.0, mod)
        amps = torch.from_numpy((lev / np.sqrt(np.mean(lev**2))).astype(np.float32))
    else:
        amps = torch.from_numpy(np.asarray(make_constellation(mod, 0.0).amps, np.float32))
    ch = 2 * amps.shape[0]
    rng = np.random.default_rng(seed)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    w1f = T(rng.uniform(-1, 1, (R, ch, 2 * k1 + 1)) * np.sqrt(6 / (2 * k1 + ch * k1)))
    w2f = T(rng.uniform(-1, 1, (R, ch, 3 * ch + 1)) * np.sqrt(6 / (4 * ch * 3)))
    h = np.zeros((R, 2, m))
    h[:, 0, m // 2] = 1.0
    h = T(h + 0.01 * rng.normal(size=h.shape))
    bn = None
    if batchnorm:
        bnp = np.stack([1.0 + 0.2 * rng.normal(size=(R, ch)), 0.1 * rng.normal(size=(R, ch))], -1)
        bn = (T(bnp), T(np.stack([np.zeros((R, ch)), np.ones((R, ch))], -1)))
    rx = T(0.5 * rng.normal(size=(R, epochs, 2, nb * 2 * bl)))
    opt = nfk.nn_frame_opt_init(w1f, w2f, h, None if bn is None else bn[0])
    return (w1f, w2f, h, opt, rx, amps, 4e-3, bn, 0.1)


CASES = {
    "net_16qam_k7": dict(mod="16-QAM", m=9, k1=7, bl=48, nb=2, epochs=4, R=2, batchnorm=False),
    "bn_16qam_k7": dict(mod="16-QAM", m=9, k1=7, bl=48, nb=2, epochs=4, R=2, batchnorm=True),
    "net_64qam_k25": dict(mod="64-QAM", m=25, k1=25, bl=70, nb=1, epochs=3, R=1, batchnorm=False),
    "bn_64qam_k25": dict(mod="64-QAM", m=25, k1=25, bl=70, nb=1, epochs=3, R=1, batchnorm=True),
    # C = 6 channels, not a multiple of 4: tiles of 2 channels
    "bn_3lev_k5": dict(mod=3, m=7, k1=5, bl=40, nb=2, epochs=2, R=2, batchnorm=True),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_experiment_block_matches_plain(emulated, case):
    """Kernel H's block (a few epochs, one eval slot every 2) against the
    plain engine at phase 13a's tolerances."""
    c = CASES[case]
    args = _inputs(**c)
    kw = dict(bl_sym=c["bl"], n_batches=c["nb"], epe=2, k1=c["k1"])
    got = nfk._launch(*args, **kw, step0=0)
    want = nfk.vae_nn_experiment_train_plain(*args, **kw)
    assert got[6].shape == (c["epochs"] * c["nb"], c["R"])
    errs: dict = {}
    chip_smoke._check("losses", got[6], want[6], 1e-4, 0.0, errs)
    for i, name in (*enumerate(NAMES), *SLOTS):
        if c["batchnorm"] or name[:2] not in ("bn", "rs"):
            chip_smoke._check(name, got[i], want[i], 1e-3, 1e-5, errs)
    for k in got[5]:
        if c["batchnorm"] or k[1] != "b":
            chip_smoke._check(k, got[5][k], want[5][k], 1e-3, 1e-5 * float(want[5][k].abs().max()),
                              errs)


@pytest.mark.parametrize("batchnorm", [False, True], ids=["net", "bn"])
def test_experiment_block_repeats_and_clocks(emulated, batchnorm):
    """Two calls give the same bits; the clocks pointer changes no output
    (the host has no clock, so every phase reads 0 there); step0 carries
    on where a call stopped, bit for bit."""
    c = dict(CASES["bn_16qam_k7" if batchnorm else "net_16qam_k7"])
    args = _inputs(**c)
    kw = dict(bl_sym=c["bl"], n_batches=c["nb"], epe=2, k1=c["k1"])
    a = nfk._launch(*args, **kw, step0=0)
    clocks = torch.ones(len(nfk.NN_CLOCK_PHASES), dtype=torch.int64)
    b = nfk._launch(*args, **kw, step0=0, clocks=clocks)
    for x, y in zip(a, b):
        for u, v in (zip(x.values(), y.values()) if isinstance(x, dict) else ((x, y),)):
            assert torch.equal(u, v)
    assert clocks.tolist() == [0] * len(nfk.NN_CLOCK_PHASES)
    # two epochs, then the other two from the state they left
    rx = args[4]
    first = nfk._launch(*args[:4], rx[:, :2].contiguous(), *args[5:], **kw, step0=0)
    bn2 = (first[3], first[4]) if batchnorm else None
    second = nfk._launch(*first[:3], first[5], rx[:, 2:].contiguous(), args[5], args[6], bn2, 0.1,
                         **kw, step0=2 * c["nb"])
    for i in range(5 if batchnorm else 3):
        assert torch.equal(second[i], a[i])
    assert torch.equal(torch.cat([first[6], second[6]]), a[6])
