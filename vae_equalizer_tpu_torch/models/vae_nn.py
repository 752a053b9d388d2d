"""VAE-NN: the two-layer convolutional equalizer / demapper of the AWGN VAE-NN
experiment (the reference's ``Net`` / ``Net_BN``, func_VAENN_MQAM.py:170-211).

Port of ``vae_equalizer_tpu/models/vae_nn.py``:

    conv(2 -> 2n, k1, pad k1//2) -> ELU -> [BatchNorm] -> conv(2n -> 2n, k2,
    stride sps, pad k2//2) -> + the sps-phase-averaged input -> softmax over
    each half (the I and the Q levels)

Parameters are a plain dict {"w1" (.., C, 2, k1), "b1" (.., C), "w2" (.., C,
C, k2), "b2" (.., C)[, "bn_scale", "bn_bias" (.., C)]} in torch's Conv1d
layout (out, in, k), with an optional leading runs axis; BatchNorm is
functional, its running statistics {"mean", "var", "momentum"} a separate
state, with torch's conventions (batch statistics in train mode, the biased
variance normalizes, the unbiased one feeds the running average).

The per-run filters are one ``F.conv1d`` per leading index.
A float32 convolution on the card goes through cuDNN, which runs TF32 by
default; at the demapper's gain that moves the SER, so ``vae_nn_forward``
turns TF32 off while it runs, and ``no_tf32`` does the same around a
backward pass.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["no_tf32", "vae_nn_forward", "vae_nn_init"]


@contextlib.contextmanager
def no_tf32():
    """Full float32 cuDNN convolutions inside the block."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _xavier_uniform(gen: torch.Generator, shape, device) -> torch.Tensor:
    """U(-a, a), a = sqrt(6 / (fan_in + fan_out)) with the receptive field in both fans."""
    a = float(np.sqrt(6.0 / (shape[1] * shape[2] + shape[0] * shape[2])))
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (u * (2 * a) - a).to(device)


def vae_nn_init(gen: torch.Generator, kernel_1: int, kernel_2: int, num_lev: int,
                batchnorm: bool = False, device="cpu"):
    """Xavier-uniform filters drawn from ``gen``, zero biases; with
    ``batchnorm`` also unit scale, zero shift and the running state (mean 0,
    var 1, momentum 0.1). Returns (params, state or None)."""
    ch = 2 * num_lev
    zeros = lambda: torch.zeros((ch,), dtype=torch.float32, device=device)
    params = {"w1": _xavier_uniform(gen, (ch, 2, kernel_1), device), "b1": zeros(),
              "w2": _xavier_uniform(gen, (ch, ch, kernel_2), device), "b2": zeros()}
    state = None
    if batchnorm:
        params["bn_scale"] = torch.ones((ch,), dtype=torch.float32, device=device)
        params["bn_bias"] = zeros()
        state = {"mean": zeros(), "var": torch.ones((ch,), dtype=torch.float32, device=device),
                 "momentum": 0.1}
    return params, state


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """Cross-correlation x (*lead, Cin, L) with w (*lead, Cout, Cin, k) + b (*lead, Cout),
    leading dims broadcast: one convolution per leading index. (One grouped
    convolution over them all picks its algorithm, and with it each group's
    rounding, by the group count (oneDNN on the CPU): a run's outputs would
    then depend on how many runs share the call, which run sharding changes,
    ``train/batching.py``.)"""
    cin, length = x.shape[-2:]
    cout, k = w.shape[-3], w.shape[-1]
    lead = torch.broadcast_shapes(x.shape[:-2], w.shape[:-3], b.shape[:-1])
    g = math.prod(lead)
    x = x.expand(lead + x.shape[-2:]).reshape(g, 1, cin, length)
    w = w.expand(lead + w.shape[-3:]).reshape(g, cout, cin, k)
    b = b.expand(lead + b.shape[-1:]).reshape(g, cout)
    out = torch.cat([F.conv1d(x[i], w[i], b[i], stride=stride, padding=pad) for i in range(g)])
    return out.reshape(lead + (cout, out.shape[-1]))


def vae_nn_forward(params: dict, x: torch.Tensor, sps: int, state: dict | None = None,
                   train: bool = True, eps: float = 1e-5):
    """x (..., 2, L) -> q (..., 2 num_lev, N)[, new_state].

    With ``state`` (Net_BN) a BatchNorm follows the ELU: in train mode with
    the batch statistics of each run's minibatch and the updated running
    state returned (detached); with ``train=False`` with the running state.
    """
    k1, k2 = params["w1"].shape[-1], params["w2"].shape[-1]
    with no_tf32():
        h = F.elu(_conv(x, params["w1"], params["b1"], 1, k1 // 2))
        new_state = state
        if state is not None:
            if train:
                mu, var = h.mean(-1), h.var(-1, unbiased=False)
                n, m = h.shape[-1], state["momentum"]
                new_state = {"mean": ((1 - m) * state["mean"] + m * mu).detach(),
                             "var": ((1 - m) * state["var"] + m * var * (n / max(n - 1, 1))).detach(),
                             "momentum": m}
            else:
                mu, var = state["mean"], state["var"]
            h = (h - mu[..., None]) * torch.rsqrt(var[..., None] + eps)
            h = h * params["bn_scale"][..., None] + params["bn_bias"][..., None]
        out = _conv(h, params["w2"], params["b2"], sps, k2 // 2)
    num_lev, n_out = out.shape[-2] // 2, out.shape[-1]
    x_res = torch.stack([x[..., i : sps * n_out : sps] for i in range(sps)]).mean(0)  # (..., 2, N)
    q = torch.cat([torch.softmax(out[..., :num_lev, :] + x_res[..., 0:1, :], dim=-2),
                   torch.softmax(out[..., num_lev:, :] + x_res[..., 1:2, :], dim=-2)], dim=-2)
    if state is not None:
        return q, new_state
    return q
