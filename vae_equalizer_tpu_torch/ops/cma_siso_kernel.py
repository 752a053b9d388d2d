"""Kernel I: the whole AWGN CMA experiment for R runs, in one launch.

No TPU kernel to replace: the JAX package runs this recurrence as a
``lax.scan`` (``vae_equalizer_tpu/models/cma.py: cma_siso``, one call per
epoch from ``train/awgn.py: run_cma_awgn``). Every epoch's symbols in
sequence (E x n_sym dependent steps, 2 M at ``AwgnCmaConfig()``): per symbol
the complex FIR output o = w . h over the window of ``M`` samples, the error
e = R - |o|^2 and the LMS update h += 2 lr e (o_re w_I + o_im w_Q, o_im w_I -
o_re w_Q), with each epoch's window index restarting on its own frame (the
reference's zero-padded y = pad(rx, M//2) per call).

Eval slots: ``h_evals`` slot i < n_evals (n_evals = E // epe) holds the taps
after epoch i*epe (0-based), the reference's eval points, as kernel G's
slots (``ops/siso_frame_kernel.py``). ``loss`` (R, E) is each epoch's mean
|e| (the JAX loop's progress "loss").

On the card (``csrc/cma_kernels.cu`` + ``cma_step.cuh``): a group of
``cma::kIGroup`` (16) lanes per run, each lane owning TPL taps of both planes
in registers for the whole experiment (2 at M = 25, 4 up to 64), its o_re /
o_im summed pairwise over its taps and closed by a 4-level shuffle
butterfly over the group in a fixed order (2 trees). Each frame is staged,
zero-padded, through a ring of 4 chunks of 512 samples per plane in shared
memory (cp.async two chunks ahead), so a symbol's window is read from
shared memory with no bounds check. Every lane sums |e| in double, off the
chain. One run a warp up to 132 runs, then two a warp. The launch is bound
by the latency of the dependent per-symbol chain, not by bytes or FLOPs.
``cma_siso_clocks`` runs the kernel once with run 0's first lane's
per-phase clock64() cycles (measurement only).

Dispatch: CPU tensors take ``cma_siso_experiment_plain`` (``models.cma.
cma_siso`` once per epoch over the runs axis); CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import torch

from ..models.cma import cma_siso
from . import _build

__all__ = ["I_CLOCK_PHASES", "cma_siso_clocks", "cma_siso_experiment", "cma_siso_experiment_plain"]

# kernel I's per-symbol phases, in the order of csrc/cma_step.cuh: enum IPhase
I_CLOCK_PHASES = ("dot", "butterfly", "error", "update", "next window")


def cma_siso_experiment_plain(rx_epochs, h, R: float, lr: float, sps: int, epe: int):
    """Plain version of kernel I (same arguments and returns as
    ``cma_siso_experiment``): ``cma_siso`` once per epoch."""
    n_epochs = rx_epochs.shape[1]
    n_evals = n_epochs // epe
    h_ev = torch.empty((n_evals,) + h.shape, dtype=h.dtype, device=h.device)
    loss = []
    for ep in range(n_epochs):
        _, h, e = cma_siso(rx_epochs[:, ep], R, h, lr, sps)
        loss.append(e.abs().mean(-1))
        if ep % epe == 0 and ep // epe < n_evals:
            h_ev[ep // epe] = h
    return h, h_ev, torch.stack(loss, dim=-1)


def cma_siso_experiment(rx_epochs, h, R: float, lr: float, sps: int, epe: int):
    """Train R runs' whole AWGN CMA experiment. Kernel I on a CUDA
    ``rx_epochs``, plain on the CPU.

    rx_epochs (runs, E, 2, n_total) every epoch's frame at ``sps`` samples
    per symbol (n_total // sps symbols); h (runs, 2, M) the initial taps; R
    the CMA modulus; lr a float.

    Returns (h' (runs, 2, M), h_evals (n_evals, runs, 2, M), loss (runs, E))
    with n_evals = E // epe.
    """
    if not rx_epochs.is_cuda:
        return cma_siso_experiment_plain(rx_epochs, h, R, lr, sps, epe)
    return _launch(rx_epochs, h, R, lr, sps, epe)


def cma_siso_clocks(rx_epochs, h, R: float, lr: float, sps: int, epe: int) -> dict:
    """Kernel I once on CUDA tensors (the arguments of ``cma_siso_experiment``)
    with its phase clocks: {phase: clock64() cycles per symbol} of run 0's
    lane 0. For measurement only (chip_smoke.py); the runners never ask for it."""
    clocks = torch.zeros(len(I_CLOCK_PHASES), dtype=torch.int64, device=rx_epochs.device)
    _launch(rx_epochs, h, R, lr, sps, epe, clocks)
    n_steps = rx_epochs.shape[1] * (rx_epochs.shape[-1] // sps)
    return {k: c / n_steps for k, c in zip(I_CLOCK_PHASES, clocks.tolist())}


def _launch(rx_epochs, h, R: float, lr: float, sps: int, epe: int, clocks=None):
    """Check the arguments, allocate the outputs and launch kernel I."""
    dev = rx_epochs.device
    runs, n_epochs, _, n_total = rx_epochs.shape
    m = h.shape[-1]
    if epe < 1 or n_total < sps:
        raise ValueError("kernel I needs epe >= 1 and at least one symbol per frame")
    for name, t, shape in (("rx_epochs", rx_epochs, (runs, n_epochs, 2, n_total)),
                           ("h", h, (runs, 2, m))):
        _build.check_tensor(name, t, shape, dev)
    n_evals = n_epochs // epe
    lib = _build.load()
    h_out = torch.empty_like(h)
    h_ev = torch.empty((n_evals, runs, 2, m), dtype=torch.float32, device=dev)
    loss = torch.empty((runs, n_epochs), dtype=torch.float32, device=dev)
    rc = lib.cma_siso_experiment_launch(
        runs, n_epochs, m, sps, n_total, epe, n_evals, rx_epochs.data_ptr(), h.data_ptr(),
        h_out.data_ptr(), h_ev.data_ptr(), loss.data_ptr(), float(R), float(2 * lr),
        None if clocks is None else clocks.data_ptr(), _build.stream(dev))
    _build.check(rc, "cma_siso_experiment_launch")
    cma_siso_experiment.launches += 1
    return h_out, h_ev, loss


_build.counted(cma_siso_experiment)
