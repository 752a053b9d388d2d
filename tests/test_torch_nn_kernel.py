"""Port parity for kernel H (``ops/nn_frame_kernel.py``): the whole AWGN VAE-NN experiment.

The plain engine ``vae_nn_experiment_train_plain`` (what CPU tensors take)
against the JAX package's TPU kernel ``vae_nn_experiment_train_pallas`` in
interpret mode, at tests/test_nn_frame_kernel.py's size (16-QAM, M 9, k1 7,
bl 48, 2 minibatches, 4 epochs, epe 2), Net and Net_BN, from the same
weights and the same numpy-seeded minibatches; and, on a card, kernel H
against the plain engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_equalizer_tpu.core import make_constellation
from vae_equalizer_tpu.models import dirac_taps_siso, vae_nn_init
from vae_equalizer_tpu.ops.nn_frame_kernel import _to_parity_major
from vae_equalizer_tpu.ops.nn_frame_kernel import flatten_nn_params as j_flatten
from vae_equalizer_tpu.ops.nn_frame_kernel import nn_frame_opt_init as j_opt_init
from vae_equalizer_tpu.ops.nn_frame_kernel import vae_nn_experiment_train_pallas
from vae_equalizer_tpu_torch.ops.nn_frame_kernel import (
    nn_frame_opt_init,
    vae_nn_experiment_train,
    vae_nn_experiment_train_plain,
)
from vae_equalizer_tpu_torch.utils.convert import nn_params_from_jax

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

M, K1, BL, NB, EPOCHS, EPE, LR = 9, 7, 48, 2, 4, 2, 2e-3


def _inputs(batchnorm: bool):
    const = make_constellation("16-QAM", 0.0)
    rng = np.random.default_rng(23)
    net, state = vae_nn_init(jax.random.PRNGKey(5), K1, 3, const.num_lev, batchnorm=batchnorm)
    net = {k: np.asarray(v) for k, v in net.items()}
    if batchnorm:  # non-trivial gamma / beta, as the JAX test
        r2 = np.random.default_rng(31)
        net["bn_scale"] = (1.0 + 0.2 * r2.normal(size=net["bn_scale"].shape)).astype(np.float32)
        net["bn_bias"] = (0.1 * r2.normal(size=net["bn_bias"].shape)).astype(np.float32)
    h0 = np.asarray(dirac_taps_siso(M)) + 0.01 * rng.normal(size=(2, M)).astype(np.float32)
    rx = (rng.normal(size=(EPOCHS, 2, NB * 2 * BL)) * 0.5).astype(np.float32)
    return const, net, state, h0.astype(np.float32), rx


def _run_jax(const, net, state, h0, rx, batchnorm):
    w1f, w2f = j_flatten({k: jnp.asarray(v) for k, v in net.items()})
    bn = None
    if batchnorm:
        bn = (jnp.stack([net["bn_scale"], net["bn_bias"]], axis=1),
              jnp.stack([state["mean"], state["var"]], axis=1))
    opt0 = j_opt_init(w1f, w2f, _to_parity_major(jnp.asarray(h0)), None if bn is None else bn[0])
    return vae_nn_experiment_train_pallas(
        w1f, w2f, jnp.asarray(h0), opt0, jnp.asarray(rx), jnp.asarray(const.amps), jnp.float32(LR),
        bn=bn, momentum=0.1, bl_sym=BL, n_batches=NB, epe=EPE, k1=K1, interpret=True)


def _port_args(const, net, state, h0, rx, batchnorm, runs=1, device="cpu"):
    from vae_equalizer_tpu_torch.ops.nn_frame_kernel import flatten_nn_params

    p = nn_params_from_jax({"net": net, "h": h0}, state, device=device)
    r = lambda t: t.expand((runs,) + t.shape).contiguous()
    w1f, w2f = (r(t) for t in flatten_nn_params(p["net"]))
    h = r(p["h"])
    bn = None
    if batchnorm:
        bn = (r(torch.stack([p["net"]["bn_scale"], p["net"]["bn_bias"]], -1)),
              r(torch.stack([p["bn"]["mean"], p["bn"]["var"]], -1)))
    opt = nn_frame_opt_init(w1f, w2f, h, None if bn is None else bn[0])
    rx_t = r(torch.from_numpy(rx).to(device))
    amps = torch.from_numpy(np.asarray(const.amps, np.float32)).to(device)
    return (w1f, w2f, h, opt, rx_t, amps, LR, bn, 0.1)


@pytest.mark.parametrize("batchnorm", [False, True])
def test_plain_engine_matches_jax_kernel(batchnorm):
    const, net, state, h0, rx = _inputs(batchnorm)
    (w1f_j, w2f_j, h_j, bnp_j, rs_j, _, losses_j,
     w1_ev_j, w2_ev_j, h_ev_j, bnp_ev_j, rs_ev_j) = _run_jax(const, net, state, h0, rx, batchnorm)
    out = vae_nn_experiment_train_plain(*_port_args(const, net, state, h0, rx, batchnorm),
                                        bl_sym=BL, n_batches=NB, epe=EPE, k1=K1)
    w1f, w2f, h, bnp, rs, opt, losses, w1_ev, w2_ev, h_ev, bnp_ev, rs_ev = out
    assert losses.shape == (EPOCHS * NB, 1) and w1_ev.shape == (EPOCHS // EPE + 1, 1, 8, 2 * K1 + 1)
    # the JAX test's tolerances (tests/test_nn_frame_kernel.py): losses rtol 3e-5,
    # parameters after 8 AMSGrad steps rtol 5e-3 / atol 1e-5, running stats rtol 1e-4
    np.testing.assert_allclose(losses[:, 0].numpy(), np.asarray(losses_j), rtol=3e-5)
    close = lambda a, b: np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-3, atol=1e-5)
    close(w1f[0], w1f_j)
    close(w2f[0], w2f_j)
    close(h[0], h_j)
    close(w1_ev[:, 0], w1_ev_j)
    close(w2_ev[:, 0], w2_ev_j)
    close(h_ev[:, 0], h_ev_j)
    if batchnorm:
        close(bnp[0], bnp_j)
        close(bnp_ev[:, 0], bnp_ev_j)
        np.testing.assert_allclose(rs[0].numpy(), np.asarray(rs_j), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(rs_ev[:, 0].numpy(), np.asarray(rs_ev_j), rtol=1e-4, atol=1e-6)
    else:
        assert not bnp.any() and not rs_ev.any()
    assert all(bool(torch.isfinite(v).all()) for v in opt.values())


def test_dispatch_and_step0():
    """CPU tensors take the plain engine; a run split in two calls (step0)
    equals one call; the eval slots follow kernel G's rule."""
    const, net, state, h0, rx = _inputs(False)
    args = _port_args(const, net, state, h0, rx, False, runs=2)
    kw = dict(bl_sym=BL, n_batches=NB, k1=K1)
    vae_nn_experiment_train.launches = 0
    full = vae_nn_experiment_train(*args, epe=EPE, **kw)
    assert vae_nn_experiment_train.launches == 0  # the plain branch counts no launch
    first = vae_nn_experiment_train(*args[:4], args[4][:, :2], *args[5:], epe=1, **kw)
    second = vae_nn_experiment_train(*first[:3], first[5], args[4][:, 2:], *args[5:], epe=1,
                                     step0=2 * NB, **kw)
    for a, b in zip(full[:3], second[:3]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    # slot i holds the parameters after epoch i * epe (0-based): epochs 0 and 2
    np.testing.assert_allclose(full[7][0].numpy(), first[7][0].numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(full[7][1].numpy(), second[7][0].numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("batchnorm", [False, True])
def test_kernel_h_matches_plain_on_card(batchnorm):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel H is CUDA C++ (no interpret mode)")
    const, net, state, h0, rx = _inputs(batchnorm)
    args = _port_args(const, net, state, h0, rx, batchnorm, runs=3, device="cuda")
    kw = dict(bl_sym=BL, n_batches=NB, epe=EPE, k1=K1)
    got = vae_nn_experiment_train(*args, **kw)
    torch.cuda.synchronize()
    want = vae_nn_experiment_train_plain(*args, **kw)
    np.testing.assert_allclose(got[6].cpu().numpy(), want[6].cpu().numpy(), rtol=1e-4)
    for i in (0, 1, 2, 3, 4, 7, 8, 9, 10, 11):
        np.testing.assert_allclose(got[i].cpu().numpy(), want[i].cpu().numpy(), rtol=5e-3, atol=1e-5)
