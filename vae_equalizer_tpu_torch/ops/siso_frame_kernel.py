"""Kernel G: the whole AWGN VAE-LE experiment for R runs, in one launch.

Replaces the TPU kernels ``vae_equalizer_tpu/ops/siso_frame_kernel.py:
vae_siso_experiment_train_pallas`` (pallas_call at :379) and its
runs-batched form ``vae_siso_experiment_train_pallas_rb`` (:727, pallas_call
:842). Every epoch's minibatches in sequence (E x n_batches dependent
steps), each kernel F's step (``ops/elbo_siso_kernel.py``) followed by
AMSGrad with optax semantics:

    mu = b1 mu + (1 - b1) g,  nu = b2 nu + (1 - b2) g^2,
    nu_max = max(nu_max, nu / bc2),  p -= lr (mu / bc1) / (sqrt(nu_max) + eps)

with b1 .9, b2 .999, eps 1e-8 and bias corrections at t = step + 1 (an
integer global step). ``torch.optim.Adam(amsgrad=True)`` is a different
rule (it takes the max over the raw second moment and divides by sqrt(bc2)
afterwards): every mode of the AWGN experiment uses ``amsgrad`` below.

Eval slots: ``w_evals`` / ``h_evals`` slot i < n_evals (n_evals = E // epe)
holds the parameters after epoch i*epe (0-based), i.e. after i*epe + 1
trained epochs — the reference's eval points (the TPU index map
``(epoch + epe - 1) // epe``, siso_frame_kernel.py:377); the last slot
holds the final parameters.

On the card (``csrc/siso_kernels.cu``): grid = R, one 512-thread block per
run; the step loop runs inside the block with w, h and the six AMSGrad
moments resident in shared memory for the whole experiment, each minibatch
copied from ``rx_epochs`` in device memory (cp.async) while the step before
it runs, AMSGrad applied in the pass that forms the gradients, each step's
loss and each eval slot written out as it is reached. 1,500 dependent steps
of six barrier-separated passes bound it (latency), and R runs fill R of
the card's 132 SMs. The TPU design (im2col on the MXU, parity-major h,
selection matmuls, stacked-sum rows) answered Mosaic's constraints and is
not carried over. ``siso_clocks`` runs the kernel once with its block's
clock64() cycles per step and phase (measurement only).

Dispatch: CPU tensors take ``vae_siso_experiment_train_plain`` (a Python
loop of kernel F's plain step plus ``amsgrad``); CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import torch

from . import _build
from .elbo_siso_kernel import SISO_CLOCK_PHASES, siso_step_plain

__all__ = [
    "amsgrad",
    "siso_clocks",
    "siso_frame_opt_init",
    "vae_siso_experiment_train",
    "vae_siso_experiment_train_plain",
]

_B1 = 0.9
_B2 = 0.999
_EPS = 1e-8
_MOMENTS = ("mw", "vw", "xw", "mh", "vh", "xh")


def siso_frame_opt_init(params: dict) -> dict:
    """Zero AMSGrad moments (mu, nu, nu_max) {"mw","vw","xw","mh","vh","xh"}
    in the shapes of w / h."""
    return {k: torch.zeros_like(params["w" if k[1] == "w" else "h"]) for k in _MOMENTS}


def amsgrad(p, mu, nu, nu_max, g, lr: float, step: int):
    """One optax.amsgrad update at global step ``step`` (t = step + 1):
    returns (p', mu', nu', nu_max'). Op for op as the kernel's."""
    bc1 = 1.0 - _B1 ** (step + 1)
    bc2 = 1.0 - _B2 ** (step + 1)
    mu = _B1 * mu + (1 - _B1) * g
    nu = _B2 * nu + (1 - _B2) * g * g
    nu_max = torch.maximum(nu_max, nu / bc2)
    return p - lr * ((mu / bc1) / (torch.sqrt(nu_max) + _EPS)), mu, nu, nu_max


def vae_siso_experiment_train_plain(w, h, opt, rx_epochs, amps, amp_mean: float, var: float, P,
                                    lr: float, *, bl_sym: int, n_batches: int, epe: int,
                                    step0: int = 0):
    """Plain version of kernel G (same arguments and returns as
    ``vae_siso_experiment_train``)."""
    n_epochs = rx_epochs.shape[1]
    n_evals = n_epochs // epe
    n_samp = 2 * bl_sym
    mw, vw, xw, mh, vh, xh = (opt[k] for k in _MOMENTS)
    w_ev = torch.empty((n_evals + 1,) + w.shape, dtype=w.dtype, device=w.device)
    h_ev = torch.empty((n_evals + 1,) + h.shape, dtype=h.dtype, device=h.device)
    losses = []
    for e in range(n_epochs):
        for b in range(n_batches):
            st = siso_step_plain(w, h, rx_epochs[:, e, :, b * n_samp : (b + 1) * n_samp], amps,
                                 amp_mean, var, P)
            losses.append(st["loss"])
            step = step0 + e * n_batches + b
            w, mw, vw, xw = amsgrad(w, mw, vw, xw, st["gw"], lr, step)
            h, mh, vh, xh = amsgrad(h, mh, vh, xh, st["gh"], lr, step)
        if e % epe == 0 and e // epe < n_evals:
            w_ev[e // epe], h_ev[e // epe] = w, h
    w_ev[n_evals], h_ev[n_evals] = w, h
    opt = dict(zip(_MOMENTS, (mw, vw, xw, mh, vh, xh)))
    return w, h, opt, torch.stack(losses), w_ev, h_ev


def vae_siso_experiment_train(w, h, opt, rx_epochs, amps, amp_mean: float, var: float, P,
                              lr: float, *, bl_sym: int, n_batches: int, epe: int, step0: int = 0):
    """Train R runs' whole experiment. Kernel G on a CUDA ``rx_epochs``, plain on the CPU.

    w (R, 1, 2, M); h (R, 2, M); opt ``siso_frame_opt_init`` moments in those
    shapes; rx_epochs (R, E, 2, n_samp) with n_samp >= n_batches * 2 bl_sym
    (epoch e's minibatch b is samples [2 bl_sym b, 2 bl_sym (b + 1)));
    amps/P (n,); step0 = global step of the first minibatch (0 for a fresh
    experiment).

    Returns (w', h', opt', losses (E n_batches, R), w_evals (n_evals + 1, R,
    1, 2, M), h_evals (n_evals + 1, R, 2, M)) with n_evals = E // epe.
    """
    if not rx_epochs.is_cuda:
        return vae_siso_experiment_train_plain(w, h, opt, rx_epochs, amps, amp_mean, var, P, lr,
                                               bl_sym=bl_sym, n_batches=n_batches, epe=epe,
                                               step0=step0)
    return _launch(w, h, opt, rx_epochs, amps, amp_mean, var, P, lr, bl_sym, n_batches, epe, step0)


def siso_clocks(w, h, opt, rx_epochs, amps, amp_mean: float, var: float, P, lr: float, *,
                bl_sym: int, n_batches: int, epe: int, step0: int = 0) -> dict:
    """Kernel G once on CUDA tensors (the arguments of
    ``vae_siso_experiment_train``) with its phase clocks: {phase: clock64()
    cycles per step} of run 0's block. For measurement only (chip_smoke.py,
    tools/); the runners never ask for it."""
    clocks = torch.zeros(len(SISO_CLOCK_PHASES), dtype=torch.int64, device=rx_epochs.device)
    _launch(w, h, opt, rx_epochs, amps, amp_mean, var, P, lr, bl_sym, n_batches, epe, step0, clocks)
    steps = rx_epochs.shape[1] * n_batches
    return {k: c / steps for k, c in zip(SISO_CLOCK_PHASES, clocks.tolist())}


def _launch(w, h, opt, rx_epochs, amps, amp_mean, var, P, lr, bl_sym, n_batches, epe, step0,
            clocks=None):
    """Check the arguments, allocate the outputs and launch kernel G."""
    dev = rx_epochs.device
    R, n_epochs, _, n_total = rx_epochs.shape
    m, n_lev = w.shape[-1], amps.shape[0]
    n_evals = n_epochs // epe
    if m % 2 != 1 or epe < 1 or n_batches < 1 or n_total < n_batches * 2 * bl_sym:
        raise ValueError("kernel G needs odd M, epe >= 1 and n_batches minibatches of 2 bl_sym "
                         "samples per epoch row")
    checks = [("rx_epochs", rx_epochs, (R, n_epochs, 2, n_total)), ("w", w, (R, 1, 2, m)),
              ("h", h, (R, 2, m)), ("amps", amps, (n_lev,)), ("P", P, (n_lev,))]
    checks += [(k, opt[k], w.shape if k[1] == "w" else h.shape) for k in _MOMENTS]
    for name, t, shape in checks:
        _build.check_tensor(name, t, shape, dev)
    lib = _build.load()
    f32 = dict(dtype=torch.float32, device=dev)
    new = {k: torch.empty_like(t) for k, t in (("w", w), ("h", h), *opt.items())}
    losses = torch.empty((n_epochs * n_batches, R), **f32)
    w_ev = torch.empty((n_evals + 1, R, 1, 2, m), **f32)
    h_ev = torch.empty((n_evals + 1, R, 2, m), **f32)
    ins = (rx_epochs, w, h, *(opt[k] for k in _MOMENTS))
    outs = (new["w"], new["h"], *(new[k] for k in _MOMENTS), losses, w_ev, h_ev)
    rc = lib.vae_siso_experiment_launch(
        R, n_epochs, n_batches, bl_sym, m, n_lev, n_total, epe, n_evals,
        *(t.data_ptr() for t in ins + outs), amps.data_ptr(), P.data_ptr(), float(amp_mean),
        float(var), float(lr), int(step0), None if clocks is None else clocks.data_ptr(),
        _build.stream(dev))
    _build.check(rc, "vae_siso_experiment_launch")
    vae_siso_experiment_train.launches += 1
    return new["w"], new["h"], {k: new[k] for k in _MOMENTS}, losses, w_ev, h_ev


vae_siso_experiment_train.launches = 0
