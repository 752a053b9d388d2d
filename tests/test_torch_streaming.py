"""Port parity for the streaming DP receiver (``models/streaming.py``) and kernel E.

The same numpy-seeded sample blocks go through the JAX package's
``StreamingReceiver`` and the port's: without adaptation (overlap-save
output passes only) and with adaptation for a few blocks from the shared
Dirac start, by both adaptation routes (``"B"``: kernel B's frame at R = 1,
its plain version on the CPU; ``"autograd"``). Route B is held to the
autograd route on a 64-QAM 2,000-symbol block, and the route rule is
checked. Kernel E's plain version (``ops/butterfly_kernel.py``) is held to
the JAX TPU kernel ``vae_le_dp_forward_pallas`` in interpret mode at sps 1
and 2; on a card, kernel E against its plain version and against itself,
and route B against the autograd route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_equalizer_tpu.core import make_constellation
from vae_equalizer_tpu.core.constellation import demapper_noise_var
from vae_equalizer_tpu.models.streaming import StreamingReceiver as JStreamingReceiver
from vae_equalizer_tpu.ops.butterfly_kernel import vae_le_dp_forward_pallas
from vae_equalizer_tpu_torch.models import butterfly_init
from vae_equalizer_tpu_torch.models import streaming
from vae_equalizer_tpu_torch.models.streaming import StreamingReceiver
from vae_equalizer_tpu_torch.ops.butterfly_kernel import (
    vae_le_dp_forward_fused,
    vae_le_dp_forward_plain,
)

torch.set_num_threads(1)


def _kwargs(mod="4-QAM", block_len=500, **kw):
    const = make_constellation(mod, 0.0)
    var = np.full((2,), demapper_noise_var(const, 20.0), np.float32)
    return dict(amps=np.asarray(const.amps, np.float32), P=np.asarray(const.P, np.float32), var=var,
                nu_sc=const.nu_sc, block_len=block_len, lr=2.5e-3, **kw)


def _jax_kwargs(kw):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}


def test_output_pass_matches_jax():
    kw = _kwargs(adapt=False)
    rng = np.random.default_rng(0)
    blocks = [rng.normal(size=(2, 2, 1000)).astype(np.float32) for _ in range(2)]
    j, p = JStreamingReceiver(**_jax_kwargs(kw)), StreamingReceiver(**kw, device="cpu")
    sj, st = j.init(), p.init()
    for blk in blocks:  # the second block carries the first one's tail
        sj, qj, oj = j.step(sj, jnp.asarray(blk))
        st, q, o = p.step(st, torch.from_numpy(blk))
        assert q.shape == (2, 4, 500) and o.shape == (2, 2, 500)
        np.testing.assert_allclose(o.numpy(), np.asarray(oj), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(q.numpy(), np.asarray(qj), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(st["tail"].numpy(), np.asarray(sj["tail"]))


@pytest.mark.parametrize("use_pallas", [False, True], ids=["autograd", "B"])
def test_adaptation_matches_jax(use_pallas):
    """Three 200-symbol blocks, two Adam steps each, from the shared Dirac
    start, by either adaptation route (route B: kernel B's plain version)."""
    kw = _kwargs(block_len=200, adapt=True)
    rng = np.random.default_rng(1)
    j, p = JStreamingReceiver(**_jax_kwargs(kw)), StreamingReceiver(**kw, use_pallas=use_pallas,
                                                                     device="cpu")
    assert p.adapt_route == ("B" if use_pallas else "autograd")
    sj, st = j.init(), p.init()
    for _ in range(3):
        blk = (0.7 * rng.normal(size=(2, 2, 400))).astype(np.float32)
        sj, qj, oj = j.step(sj, jnp.asarray(blk))
        st, q, o = p.step(st, torch.from_numpy(blk))
    assert st["opt"]["step"] == 6
    # six Adam steps of float32 rounding-order drift: taps to 1e-5
    np.testing.assert_allclose(st["params"]["w"].numpy(), np.asarray(sj["params"]["w"]), atol=1e-5)
    np.testing.assert_allclose(st["params"]["h"].numpy(), np.asarray(sj["params"]["h"]), atol=1e-5)
    # outputs: taps ~1e-5 apart over a 4 x 25-tap window of unit-scale samples
    np.testing.assert_allclose(o.numpy(), np.asarray(oj), rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(q.numpy(), np.asarray(qj), atol=1e-3)


def _block_64qam(seed=5):
    """64-QAM receiver arguments at 23 dB and one 2,000-symbol block (sps 2)."""
    kw = _kwargs(mod="64-QAM", block_len=2000, adapt=True)
    kw["var"] = np.full((2,), demapper_noise_var(make_constellation("64-QAM", 0.0), 23.0), np.float32)
    blk = (0.7 * np.random.default_rng(seed).normal(size=(2, 2, 4000))).astype(np.float32)
    return kw, blk


def _hold_routes(b, a):
    """Route B against the autograd route after one 2,000-symbol block (20
    Adam steps from the Dirac start): taps to 1e-5, as the receiver's JAX
    check after 6 steps (measured: ~1.5e-6); the moments, raw gradients of
    scale ~1e1-1e2 summed in another order, to 1e-3 of their scale
    (measured: ~1.6e-4); q and out as the output passes of taps 1e-5 apart."""
    assert a["step"] == b["step"] == 20
    for k in ("w", "h"):
        np.testing.assert_allclose(b[k], a[k], atol=1e-5)
    for k in ("mw", "vw", "mh", "vh"):
        np.testing.assert_allclose(b[k], a[k], atol=1e-3 * float(np.abs(a[k]).max()))
    np.testing.assert_allclose(b["out"], a["out"], rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(b["q"], a["q"], atol=1e-3)


def _run_routes(device):
    """One 64-QAM block through each route: {route: taps, moments, step, q, out}."""
    kw, blk = _block_64qam()
    res = {}
    for use_pallas in (False, True):
        rxr = StreamingReceiver(**kw, use_pallas=use_pallas, device=device)
        st, q, o = rxr.step(rxr.init(), torch.from_numpy(blk).to(device))
        got = {**st["params"], **{k: st["opt"][k] for k in ("mw", "vw", "mh", "vh")}, "q": q, "out": o}
        res[rxr.adapt_route] = {"step": st["opt"]["step"], **{k: v.cpu().numpy() for k, v in got.items()}}
    return res


def test_route_b_matches_autograd():
    res = _run_routes("cpu")
    _hold_routes(res["B"], res["autograd"])


@pytest.mark.parametrize("sps,use_pallas,route", [(1, True, "autograd"), (2, False, "autograd"),
                                                   (2, True, "B")])
def test_adapt_route_rule(monkeypatch, sps, use_pallas, route):
    """The route follows use_pallas and the shapes; route B makes one
    ``vae_dp_frame_train`` call per block and the autograd route none."""
    calls = []
    real = streaming.vae_dp_frame_train
    monkeypatch.setattr(streaming, "vae_dp_frame_train", lambda *a, **k: calls.append(1) or real(*a, **k))
    kw = _kwargs(block_len=200, adapt=True, sps=sps)
    rxr = StreamingReceiver(**kw, use_pallas=use_pallas, device="cpu")
    assert rxr.adapt_route == route
    assert StreamingReceiver(**{**kw, "adapt": False}, use_pallas=use_pallas,
                             device="cpu").adapt_route is None
    st = rxr.init()
    rng = np.random.default_rng(3)
    for b in range(3):
        st, q, o = rxr.step(st, torch.from_numpy(rng.normal(size=(2, 2, 200 * sps)).astype(np.float32)))
        assert st["opt"]["step"] == 2 * (b + 1) and q.shape == (2, 4, 200)
    assert len(calls) == (3 if route == "B" else 0)


@pytest.mark.parametrize("sps", [1, 2])
def test_plain_e_matches_jax_kernel(sps):
    kw = _kwargs(mod="16-QAM")
    rng = np.random.default_rng(2)
    w = (np.asarray(butterfly_init(25)) + 0.05 * rng.normal(size=(2, 4, 25))).astype(np.float32)
    x = rng.normal(size=(2, 2, 600)).astype(np.float32)
    qj, oj = vae_le_dp_forward_pallas(jnp.asarray(w), jnp.asarray(x), jnp.asarray(kw["amps"]),
                                      jnp.asarray(kw["var"]), kw["nu_sc"], sps, interpret=True)
    q, o = vae_le_dp_forward_plain(torch.from_numpy(w), torch.from_numpy(x),
                                   torch.from_numpy(kw["amps"]), torch.from_numpy(kw["var"]),
                                   kw["nu_sc"], sps)
    assert q.shape == (2, 8, 600 // sps) and o.shape == (2, 2, 600 // sps)
    # the JAX test's tolerances (tests/test_streaming.py:78-79)
    np.testing.assert_allclose(o.numpy(), np.asarray(oj), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(q.numpy(), np.asarray(qj), rtol=5e-4, atol=2e-6)
    # CPU tensors take the plain version and count no launch
    vae_le_dp_forward_fused.launches = 0
    q2, _ = vae_le_dp_forward_fused(torch.from_numpy(w), torch.from_numpy(x),
                                    torch.from_numpy(kw["amps"]), torch.from_numpy(kw["var"]),
                                    kw["nu_sc"], sps)
    assert torch.equal(q2, q) and vae_le_dp_forward_fused.launches == 0


def test_receiver_on_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingReceiver(**_kwargs())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("sps", [1, 2])
def test_kernel_e_matches_plain_on_card(sps):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel E is CUDA C++ (no interpret mode)")
    kw = _kwargs(mod="64-QAM")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    w = (butterfly_init(25, dev) + 0.05 * torch.randn((2, 4, 25), generator=g, device=dev)).contiguous()
    x = torch.randn((2, 2, 2 * 2012), generator=g, device=dev)
    args = (w, x, torch.from_numpy(kw["amps"]).to(dev), torch.from_numpy(kw["var"]).to(dev),
            kw["nu_sc"], sps)
    q, o = vae_le_dp_forward_fused(*args)
    torch.cuda.synchronize()
    qp, op = vae_le_dp_forward_plain(*args)
    np.testing.assert_allclose(o.cpu().numpy(), op.cpu().numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(q.cpu().numpy(), qp.cpu().numpy(), rtol=5e-4, atol=2e-6)


@pytest.mark.requires_cuda
def test_kernel_e_bit_for_bit_on_card():
    """Two launches of kernel E on the same inputs give the same bits (no
    atomics, fixed summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel E is CUDA C++ (no interpret mode)")
    kw = _kwargs(mod="64-QAM")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    w = (butterfly_init(25, dev) + 0.05 * torch.randn((2, 4, 25), generator=g, device=dev)).contiguous()
    x = torch.randn((2, 2, 2 * 2012), generator=g, device=dev)
    args = (w, x, torch.from_numpy(kw["amps"]).to(dev), torch.from_numpy(kw["var"]).to(dev),
            kw["nu_sc"], 2)
    one, two = vae_le_dp_forward_fused(*args), vae_le_dp_forward_fused(*args)
    assert all(torch.equal(u, v) for u, v in zip(one, two))


@pytest.mark.requires_cuda
def test_route_b_matches_autograd_on_card():
    """One 2,000-symbol block on the card: route B (one kernel-B launch)
    against the autograd route, at the CPU test's tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel B is CUDA C++ (no interpret mode)")
    from vae_equalizer_tpu_torch.ops.frame_kernel import vae_dp_frame_train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vae_dp_frame_train.launches = 0
    res = _run_routes("cuda")
    assert vae_dp_frame_train.launches == 1
    _hold_routes(res["B"], res["autograd"])
