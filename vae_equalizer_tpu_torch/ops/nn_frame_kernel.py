"""Kernel H: the whole AWGN VAE-NN experiment for R runs, in one launch.

Replaces the TPU kernel ``vae_equalizer_tpu/ops/nn_frame_kernel.py:
vae_nn_experiment_train_pallas`` (pallas_call at :500). Every epoch's
minibatches in sequence (E x n_batches dependent steps); one step is

    conv1 (2 -> C, k1) + bias -> ELU -> [BatchNorm, batch statistics]
    -> conv2 (C -> C, 3, stride 2) + bias -> + sps-phase-averaged residual
    -> softmax over each half -> uniform-prior SISO ELBO
    (n_eff log C - entropy) -> its gradient -> AMSGrad (optax semantics,
    ``ops/siso_frame_kernel.py: amsgrad``) on W1, W2, h and, for Net_BN,
    (gamma, beta); the BatchNorm running statistics follow torch's
    momentum rule outside the optimizer.

Parameters travel flat, in the JAX package's layout (``flatten_nn_params``):
W1' (C, 2 k1 + 1) with column 2k + i = w1[:, i, k] and the bias last, W2'
(C, 3C + 1) with column d C + j = w2[:, j, d] and the bias last; BatchNorm's
(gamma | beta) and (running mean | running var) as (C, 2). h is (2, M) in
natural tap order (the TPU kernel's parity-major h was a Mosaic layout).

Eval slots: slot i < n_evals (n_evals = E // epe) holds the parameters after
epoch i*epe (0-based), the last slot the final ones — kernel G's rule.

On the card (``csrc/nn_kernels.cu`` + ``nn_step.cuh``): grid = R, one
512-thread block per run; the step loop runs inside the block with the
parameters, their AMSGrad moments and one minibatch's activations in ~155 KB
(Net_BN ~195 KB) of shared memory. The convolutions and weight gradients are
warp items of register tiles (G channels x samples, or G channels x columns
with the sum split over the lanes and closed by a fixed-order
reduce-scatter); the ELBO and its gradient are H's own uniform-prior back
end (P = 1, so the KL is the plain entropy); the next minibatch arrives by
cp.async during the step. Sums run in a fixed order without atomics, so a
run repeats bit for bit. What bounds a step is each phase's shared-memory
wavefronts and issue on one SM, over 6,500 dependent steps of 12
barrier-separated phases; R runs fill R of the card's 132 SMs.

``nn_clocks`` runs the kernel once with its block's per-phase clock64()
cycles (measurement only).

Dispatch: CPU tensors take ``vae_nn_experiment_train_plain`` (a Python loop
of autograd through ``models/vae_nn.py: vae_nn_forward`` + ``elbo_siso``
with P = None, then ``amsgrad``); CUDA tensors launch the kernel or raise.
Restrictions, as in JAX: sps 2, odd M, k2 = 3.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.losses import elbo_siso
from ..models.vae_nn import no_tf32, vae_nn_forward
from . import _build
from .siso_frame_kernel import amsgrad

__all__ = [
    "NN_CLOCK_PHASES",
    "flatten_nn_params",
    "nn_clocks",
    "nn_frame_opt_init",
    "nn_net",
    "unflatten_nn_params",
    "vae_nn_experiment_train",
    "vae_nn_experiment_train_plain",
]

# kernel H's step phases, in the order of csrc/nn_step.cuh: enum Phase
NN_CLOCK_PHASES = ("load x", "conv1+ELU", "BN forward", "conv2+residual", "softmax+moments",
                   "ELBO forward", "gd/gh/gq+softmax VJP", "gW2", "conv2T", "BN VJP+ELU VJP", "gW1",
                   "AMSGrad")

# moment names: (m, v, x) = (mu, nu, nu_max) of W1' (1), W2' (2), h (h), BN (gamma | beta) (b)
_MOMENTS = ("m1", "v1", "x1", "m2", "v2", "x2", "mh", "vh", "xh", "mb", "vb", "xb")


def flatten_nn_params(net: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """{"w1","b1","w2","b2"} (leading dims allowed) -> (W1' (.., C, 2 k1 + 1), W2' (.., C, 3C + 1))."""
    w1, w2 = net["w1"], net["w2"]
    w1f = torch.cat([w1.movedim(-2, -1).flatten(-2), net["b1"][..., None]], dim=-1)
    w2f = torch.cat([w2[..., 0], w2[..., 1], w2[..., 2], net["b2"][..., None]], dim=-1)
    return w1f, w2f


def unflatten_nn_params(w1f: torch.Tensor, w2f: torch.Tensor, k1: int) -> dict:
    """Inverse of ``flatten_nn_params`` (views where possible, so autograd
    reaches the flat tensors)."""
    ch = w1f.shape[-2]
    w1 = w1f[..., : 2 * k1].unflatten(-1, (k1, 2)).movedim(-1, -2)
    w2 = torch.stack([w2f[..., 0:ch], w2f[..., ch : 2 * ch], w2f[..., 2 * ch : 3 * ch]], dim=-1)
    return {"w1": w1, "b1": w1f[..., 2 * k1], "w2": w2, "b2": w2f[..., 3 * ch]}


def nn_frame_opt_init(w1f, w2f, h, bnp=None) -> dict:
    """Zero AMSGrad moments {"m1","v1","x1","m2",...,"xb"} in the shapes of
    W1', W2', h and (gamma | beta) (zeros (.., C, 2) when ``bnp`` is None)."""
    if bnp is None:
        bnp = w1f.new_zeros(w1f.shape[:-1] + (2,))
    like = {"1": w1f, "2": w2f, "h": h, "b": bnp}
    return {k: torch.zeros_like(like[k[1]]) for k in _MOMENTS}


def nn_net(w1f, w2f, bnp, k1: int, batchnorm: bool) -> dict:
    """Flat parameters (leading dims allowed) and, for Net_BN, (gamma | beta)
    bnp (.., C, 2) -> the ``models/vae_nn.py: vae_nn_forward`` dict."""
    net = unflatten_nn_params(w1f, w2f, k1)
    if batchnorm:
        net["bn_scale"], net["bn_bias"] = bnp[..., 0], bnp[..., 1]
    return net


def nn_step_plain(w1f, w2f, h, bnp, rs, x, amps, momentum: float, k1: int, batchnorm: bool):
    """One minibatch of R runs: (loss (R,), gW1', gW2', gh, g(gamma|beta) or
    None, the new running statistics (R, C, 2) or ``rs``). Autograd through
    ``vae_nn_forward`` + the uniform-prior ``elbo_siso``."""
    leaves = [t.detach().requires_grad_() for t in (w1f, w2f, h)]
    if batchnorm:
        leaves.append(bnp.detach().requires_grad_())
    with no_tf32():
        net = nn_net(leaves[0], leaves[1], leaves[-1], k1, batchnorm)
        if batchnorm:
            state = {"mean": rs[..., 0], "var": rs[..., 1], "momentum": momentum}
            q, new = vae_nn_forward(net, x, 2, state=state, train=True)
            rs = torch.stack([new["mean"], new["var"]], dim=-1)
        else:
            q = vae_nn_forward(net, x, 2)
        loss = elbo_siso(q, x, leaves[2], amps, None)  # (R,): runs are independent
        grads = torch.autograd.grad(loss.sum(), leaves)
    return (loss.detach(), *grads[:3], grads[3] if batchnorm else None, rs)


def vae_nn_experiment_train_plain(w1f, w2f, h, opt, rx_epochs, amps, lr: float, bn=None,
                                  momentum: float = 0.1, *, bl_sym: int, n_batches: int, epe: int,
                                  k1: int, step0: int = 0, bias=None):
    """Plain version of kernel H (same arguments and returns as
    ``vae_nn_experiment_train``); ``bias`` (E n_batches, 2), rows of
    ``amsgrad_schedule``, gives the steps' bias corrections in place of
    ``step0`` (the device form the loop mode's CUDA graph reads)."""
    n_epochs = rx_epochs.shape[1]
    n_evals = n_epochs // epe
    n_samp = 2 * bl_sym
    batchnorm = bn is not None
    bnp, rs = bn if batchnorm else (w1f.new_zeros(w1f.shape[:-1] + (2,)),) * 2
    p = {"1": w1f, "2": w2f, "h": h, "b": bnp}
    mom = dict(opt)
    keys = ("1", "2", "h", "b") if batchnorm else ("1", "2", "h")
    ev = {k: [] for k in ("1", "2", "h", "b", "rs")}
    losses = []

    def snapshot():
        for k in ("1", "2", "h", "b"):
            ev[k].append(p[k])
        ev["rs"].append(rs)

    for e in range(n_epochs):
        for b in range(n_batches):
            x = rx_epochs[:, e, :, b * n_samp : (b + 1) * n_samp]
            loss, *g, rs = nn_step_plain(p["1"], p["2"], p["h"], p["b"], rs, x, amps, momentum, k1,
                                         batchnorm)
            losses.append(loss)
            step = step0 + e * n_batches + b if bias is None else bias[e * n_batches + b]
            for k in keys:
                p[k], mom["m" + k], mom["v" + k], mom["x" + k] = amsgrad(
                    p[k], mom["m" + k], mom["v" + k], mom["x" + k], g["12hb".index(k)], lr, step)
        if e % epe == 0 and e // epe < n_evals:
            snapshot()
    snapshot()
    evs = [torch.stack(ev[k]) for k in ("1", "2", "h", "b", "rs")]
    return (p["1"], p["2"], p["h"], p["b"], rs, mom, torch.stack(losses), *evs)


def vae_nn_experiment_train(w1f, w2f, h, opt, rx_epochs, amps, lr: float, bn=None,
                            momentum: float = 0.1, *, bl_sym: int, n_batches: int, epe: int,
                            k1: int, step0: int = 0):
    """Train R runs' whole VAE-NN experiment. Kernel H on a CUDA
    ``rx_epochs``, plain on the CPU.

    w1f (R, C, 2 k1 + 1), w2f (R, C, 3C + 1) flat parameters; h (R, 2, M);
    opt ``nn_frame_opt_init`` moments in those shapes; rx_epochs (R, E, 2,
    n_samp) with n_samp >= n_batches * 2 bl_sym (epoch e's minibatch b is
    samples [2 bl_sym b, 2 bl_sym (b + 1))); amps (n,) with C = 2n; bn (Net_BN)
    ((gamma | beta) (R, C, 2), (running mean | running var) (R, C, 2)) or
    None; step0 = global step of the first minibatch (0 for a fresh
    experiment).

    Returns (w1f', w2f', h', bnp', rs', opt', losses (E n_batches, R),
    w1_evals, w2_evals, h_evals, bnp_evals, rs_evals), each evals tensor
    (n_evals + 1, R, ...) with n_evals = E // epe; without ``bn`` bnp / rs
    and their slots are zeros.
    """
    kw = dict(bl_sym=bl_sym, n_batches=n_batches, epe=epe, k1=k1, step0=step0)
    if not rx_epochs.is_cuda:
        return vae_nn_experiment_train_plain(w1f, w2f, h, opt, rx_epochs, amps, lr, bn, momentum,
                                             **kw)
    return _launch(w1f, w2f, h, opt, rx_epochs, amps, lr, bn, momentum, **kw)


def nn_clocks(w1f, w2f, h, opt, rx_epochs, amps, lr: float, bn=None, momentum: float = 0.1, *,
              bl_sym: int, n_batches: int, epe: int, k1: int, step0: int = 0) -> dict:
    """Kernel H once on CUDA tensors (the arguments of ``vae_nn_experiment_train``)
    with its phase clocks: {phase: clock64() cycles per step} of run 0's block,
    averaged over the call's steps. For measurement only (chip_smoke.py,
    tools/); the runners never ask for it."""
    clocks = torch.zeros(len(NN_CLOCK_PHASES), dtype=torch.int64, device=rx_epochs.device)
    res = _launch(w1f, w2f, h, opt, rx_epochs, amps, lr, bn, momentum, bl_sym=bl_sym,
                  n_batches=n_batches, epe=epe, k1=k1, step0=step0, clocks=clocks)
    steps = res[6].shape[0]
    return {k: c / steps for k, c in zip(NN_CLOCK_PHASES, clocks.tolist())}


def _launch(w1f, w2f, h, opt, rx_epochs, amps, lr, bn, momentum, *, bl_sym, n_batches, epe, k1,
            step0, clocks=None):
    """Check the arguments, allocate the outputs and launch kernel H (with
    ``clocks``, an int64 tensor of len(NN_CLOCK_PHASES), its phase cycles)."""
    dev = rx_epochs.device
    R, n_epochs, _, n_total = rx_epochs.shape
    m, n_lev = h.shape[-1], amps.shape[0]
    ch = 2 * n_lev
    n_evals = n_epochs // epe
    if m % 2 != 1 or epe < 1 or n_batches < 1 or n_total < n_batches * 2 * bl_sym:
        raise ValueError("kernel H needs odd M, epe >= 1 and n_batches minibatches of 2 bl_sym "
                         "samples per epoch row")
    batchnorm = bn is not None
    bnp, rs = bn if batchnorm else (torch.zeros((R, ch, 2), dtype=torch.float32, device=dev),) * 2
    shapes = {"1": (R, ch, 2 * k1 + 1), "2": (R, ch, 3 * ch + 1), "h": (R, 2, m), "b": (R, ch, 2)}
    checks = [("rx_epochs", rx_epochs, (R, n_epochs, 2, n_total)), ("w1f", w1f, shapes["1"]),
              ("w2f", w2f, shapes["2"]), ("h", h, shapes["h"]), ("bnp", bnp, shapes["b"]),
              ("rs", rs, shapes["b"]), ("amps", amps, (n_lev,))]
    checks += [(k, opt[k], shapes[k[1]]) for k in _MOMENTS]
    for name, t, shape in checks:
        _build.check_tensor(name, t, shape, dev)
    lib = _build.load()
    f32 = dict(dtype=torch.float32, device=dev)
    ins = (w1f, w2f, h, bnp, rs, *(opt[k] for k in _MOMENTS))
    new = [torch.empty_like(t) for t in ins]
    losses = torch.empty((n_epochs * n_batches, R), **f32)
    evs = [torch.empty((n_evals + 1,) + s, **f32)
           for s in (shapes["1"], shapes["2"], shapes["h"], shapes["b"], shapes["b"])]
    # pointer table, in the order of csrc/nn_step.cuh: NnPtrs
    tensors = (rx_epochs, *ins, *new, losses, *evs, amps)
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    rc = lib.vae_nn_experiment_launch(
        R, n_epochs, n_batches, bl_sym, m, n_lev, k1, n_total, epe, n_evals, int(batchnorm), ptrs,
        float(lr), float(momentum), int(step0), None if clocks is None else clocks.data_ptr(),
        _build.stream(dev))
    _build.check(rc, "vae_nn_experiment_launch")
    vae_nn_experiment_train.launches += 1
    opt_new = dict(zip(_MOMENTS, new[5:]))
    return (*new[:5], opt_new, losses, *evs)


_build.counted(vae_nn_experiment_train)
