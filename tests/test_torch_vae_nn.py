"""Port parity for the VAE-NN model (``models/vae_nn.py``) and its flat layout.

The same numpy-seeded inputs and the JAX package's own weights go through
``vae_equalizer_tpu.models.vae_nn_forward`` and the port's
``vae_nn_forward``: Net against the reference golden, Net and Net_BN (train
and eval mode) against JAX, the gradients of ``elbo_siso o vae_nn_forward``
against ``jax.grad``, and the flat parameter layout of kernel H against
JAX's ``flatten_nn_params`` / ``unflatten_nn_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_equalizer_tpu.core import make_constellation
from vae_equalizer_tpu.models import vae_nn_forward as j_vae_nn_forward
from vae_equalizer_tpu.models import vae_nn_init as j_vae_nn_init
from vae_equalizer_tpu.models.losses import elbo_siso as j_elbo_siso
from vae_equalizer_tpu.ops.nn_frame_kernel import flatten_nn_params as j_flatten
from vae_equalizer_tpu.ops.nn_frame_kernel import unflatten_nn_params as j_unflatten
from vae_equalizer_tpu_torch.models import elbo_siso, vae_nn_forward, vae_nn_init
from vae_equalizer_tpu_torch.ops.nn_frame_kernel import flatten_nn_params, unflatten_nn_params
from vae_equalizer_tpu_torch.utils.convert import nn_params_from_jax

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

K1, M, BL = 9, 9, 64


def _jax_net(batchnorm: bool, seed: int = 3):
    """JAX-initialized weights with non-trivial biases (and BN scale / shift / stats)."""
    const = make_constellation("16-QAM", 0.0)
    net, state = j_vae_nn_init(jax.random.PRNGKey(seed), K1, 3, const.num_lev, batchnorm=batchnorm)
    rng = np.random.default_rng(seed)
    net = {k: np.asarray(v) for k, v in net.items()}
    net["b1"] = (0.1 * rng.normal(size=net["b1"].shape)).astype(np.float32)
    net["b2"] = (0.1 * rng.normal(size=net["b2"].shape)).astype(np.float32)
    if batchnorm:
        net["bn_scale"] = (1 + 0.2 * rng.normal(size=net["bn_scale"].shape)).astype(np.float32)
        net["bn_bias"] = (0.1 * rng.normal(size=net["bn_bias"].shape)).astype(np.float32)
        state = {"mean": (0.1 * rng.normal(size=(8,))).astype(np.float32),
                 "var": (1 + 0.1 * rng.random(size=(8,))).astype(np.float32), "momentum": 0.1}
    return const, net, state


def test_forward_golden(golden):
    g = golden("vaenn_net")
    net = {"w1": torch.from_numpy(g["fc1_weight"]), "b1": torch.from_numpy(g["fc1_bias"]),
           "w2": torch.from_numpy(g["fc2_weight"]), "b2": torch.from_numpy(g["fc2_bias"])}
    q = vae_nn_forward(net, torch.from_numpy(g["x"]), sps=2)  # (1, 2, 128): a runs axis of 1
    assert q.shape == (1, 16, 64)
    np.testing.assert_allclose(q.numpy(), g["out"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(q[0, :8].sum(0).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("batchnorm,train", [(False, True), (True, True), (True, False)])
def test_forward_matches_jax(batchnorm, train):
    const, net, state = _jax_net(batchnorm)
    x = np.random.default_rng(1).normal(size=(2, 2 * BL)).astype(np.float32)
    p = nn_params_from_jax({"net": net, "h": np.zeros((2, M), np.float32)}, state)
    if batchnorm:
        q_j, st_j = j_vae_nn_forward(net, jnp.asarray(x), 2, state=state, train=train)
        q, st = vae_nn_forward(p["net"], torch.from_numpy(x), 2, state=p["bn"], train=train)
        # float32 sums in another order; the running stats move by 0.1 of a batch statistic
        np.testing.assert_allclose(st["mean"].numpy(), np.asarray(st_j["mean"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(st["var"].numpy(), np.asarray(st_j["var"]), rtol=1e-5, atol=1e-6)
    else:
        q_j = j_vae_nn_forward(net, jnp.asarray(x), 2)
        q = vae_nn_forward(p["net"], torch.from_numpy(x), 2)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), rtol=1e-4, atol=1e-6)


def test_runs_axis_and_init():
    """Per-run weights through the grouped conv equal run-by-run calls; the
    Xavier bounds are JAX's."""
    gen = torch.Generator()
    gen.manual_seed(0)
    nets = [vae_nn_init(gen, K1, 3, 8)[0] for _ in range(3)]
    for net in nets:
        a1 = np.sqrt(6 / (2 * K1 + 16 * K1))
        assert float(net["w1"].abs().max()) <= a1 and float(net["w1"].abs().max()) > 0.5 * a1
        assert float(net["w2"].abs().max()) <= np.sqrt(6 / (16 * 3 + 16 * 3))
    stacked = {k: torch.stack([n[k] for n in nets]) for k in nets[0]}
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 2, 2 * BL)).astype(np.float32))
    q = vae_nn_forward(stacked, x, 2)
    for r in range(3):
        np.testing.assert_allclose(q[r].numpy(), vae_nn_forward(nets[r], x[r], 2).numpy(),
                                   rtol=1e-5, atol=1e-7)
    # shared weights over a batch of inputs
    np.testing.assert_allclose(vae_nn_forward(nets[0], x, 2)[1].numpy(),
                               vae_nn_forward(nets[0], x[1], 2).numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("batchnorm", [False, True])
def test_elbo_gradients_match_jax(batchnorm):
    const, net, state = _jax_net(batchnorm, seed=4)
    rng = np.random.default_rng(5)
    x = (0.7 * rng.normal(size=(2, 2 * BL))).astype(np.float32)
    h = np.zeros((2, M), np.float32)
    h[0, M // 2] = 1.0
    h = h + (0.05 * rng.normal(size=h.shape)).astype(np.float32)
    amps = np.asarray(const.amps, np.float32)

    def j_loss(p):
        if batchnorm:
            q, _ = j_vae_nn_forward(p["net"], jnp.asarray(x), 2, state=state, train=True)
        else:
            q = j_vae_nn_forward(p["net"], jnp.asarray(x), 2)
        return j_elbo_siso(q, jnp.asarray(x), p["h"], jnp.asarray(amps), None)

    loss_j, g_j = jax.value_and_grad(j_loss)({"net": net, "h": jnp.asarray(h)})
    p = nn_params_from_jax({"net": net, "h": h}, state)
    leaves = {k: v.requires_grad_() for k, v in p["net"].items()}
    h_t = p["h"].requires_grad_()
    if batchnorm:
        q, _ = vae_nn_forward(leaves, torch.from_numpy(x), 2, state=p["bn"], train=True)
    else:
        q = vae_nn_forward(leaves, torch.from_numpy(x), 2)
    loss = elbo_siso(q, torch.from_numpy(x), h_t, torch.from_numpy(amps), None)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    # gradients to 1e-4 of each tensor's scale: float32 sums in another order
    for k, v in leaves.items():
        want = np.asarray(g_j["net"][k])
        np.testing.assert_allclose(v.grad.numpy(), want, rtol=1e-3, atol=1e-4 * np.abs(want).max())
    want = np.asarray(g_j["h"])
    np.testing.assert_allclose(h_t.grad.numpy(), want, rtol=1e-3, atol=1e-4 * np.abs(want).max())


def test_flat_layout_matches_jax():
    _, net, _ = _jax_net(False)
    w1f_j, w2f_j = j_flatten({k: jnp.asarray(v) for k, v in net.items()})
    p = nn_params_from_jax({"net": net, "h": np.zeros((2, M), np.float32)})
    w1f, w2f = flatten_nn_params(p["net"])
    np.testing.assert_array_equal(w1f.numpy(), np.asarray(w1f_j))
    np.testing.assert_array_equal(w2f.numpy(), np.asarray(w2f_j))
    back = unflatten_nn_params(w1f, w2f, K1)
    back_j = j_unflatten(w1f_j, w2f_j, K1)
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_array_equal(back[k].numpy(), net[k])
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(back_j[k]))
    # a leading runs axis round-trips too
    w1r, w2r = flatten_nn_params({k: v.expand((2,) + v.shape) for k, v in p["net"].items()})
    assert w1r.shape == (2, 8, 2 * K1 + 1) and w2r.shape == (2, 8, 3 * 8 + 1)
    np.testing.assert_array_equal(unflatten_nn_params(w1r, w2r, K1)["w2"][1].numpy(), net["w2"])


@pytest.mark.parametrize("batchnorm", [False, True])
def test_amsgrad_state_from_jax(batchnorm):
    """optax AMSGrad over {"net", "h"} (Net_BN: the "train" part of
    multi_transform) -> kernel H's flat moments and the step count."""
    import optax

    from vae_equalizer_tpu_torch.utils.convert import nn_amsgrad_state_from_jax

    _, net, state = _jax_net(batchnorm)
    params = {"net": {k: jnp.asarray(v) for k, v in net.items()}, "h": jnp.ones((2, M))}
    if batchnorm:
        params["bn"] = {k: jnp.asarray(v) for k, v in state.items()}
        opt = optax.multi_transform({"train": optax.amsgrad(1e-3), "frozen": optax.set_to_zero()},
                                    {"net": "train", "h": "train", "bn": "frozen"})
    else:
        opt = optax.amsgrad(1e-3)
    s = opt.init(params)
    for i in range(3):
        g = jax.tree.map(lambda p, i=i: jnp.sin(jnp.arange(p.size, dtype=jnp.float32) + i).reshape(p.shape),
                         params)
        _, s = opt.update(g, s, params)
    moments, count = nn_amsgrad_state_from_jax(s)
    assert count == 3 and set(moments) == {a + b for b in "12hb" for a in "mvx"}
    ams = s[0] if not batchnorm else s.inner_states["train"].inner_state[0]
    for key, tree in (("m", ams.mu), ("v", ams.nu), ("x", ams.nu_max)):
        w1f_j, w2f_j = j_flatten(tree["net"])
        np.testing.assert_array_equal(moments[key + "1"].numpy(), np.asarray(w1f_j))
        np.testing.assert_array_equal(moments[key + "2"].numpy(), np.asarray(w2f_j))
        np.testing.assert_array_equal(moments[key + "h"].numpy(), np.asarray(tree["h"]))
        if batchnorm:
            np.testing.assert_array_equal(moments[key + "b"][:, 0].numpy(),
                                          np.asarray(tree["net"]["bn_scale"]))
        else:
            assert not moments[key + "b"].any()
