"""Kernel E: the DP VAE-LE inference pass (2x2 butterfly FIR + PCS softmin
demapper) in one launch.

Replaces the TPU kernel ``vae_equalizer_tpu/ops/butterfly_kernel.py:
vae_le_dp_forward_pallas`` (pallas_call at :135), the output pass of the
streaming receiver (``models/streaming.py``). Same shapes as the JAX
function: w (2, 4, M), x (2, 2, L) -> q (2, 2n, N), out (2, 2, N) with
N = (L + 2 (M // 2) - M) // sps + 1, any sps.

On the card (``csrc/butterfly_kernel.cu``): one thread per (output,
symbol), 32 symbols a block, computes one butterfly output from the block's
input window staged in shared memory and its softmin demapper, with
branch-free exact divisions; the pass is a few MFLOP over a few hundred KB,
so a launch bounds it. ``butterfly_clocks`` runs it once with block 0's
thread 0 clock64() cycles per phase (measurement only).

Dispatch: CPU tensors take ``vae_le_dp_forward_plain`` (the model's
``vae_le_dp_forward``); CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from ..models.vae_le import vae_le_dp_forward
from . import _build

__all__ = ["CLOCK_PHASES", "butterfly_clocks", "vae_le_dp_forward_fused", "vae_le_dp_forward_plain"]

# kernel E's phases, in the order of csrc/butterfly_kernel.cu
CLOCK_PHASES = ("stage", "FIR", "metric/min", "exp/sum", "normalize/store")


# the plain version of kernel E is the model's forward itself
vae_le_dp_forward_plain = vae_le_dp_forward


def vae_le_dp_forward_fused(w, x, amps, var, nu_sc: float, sps: int):
    """Butterfly + demapper, (q (2, 2n, N), out (2, 2, N)). Kernel E on a
    CUDA ``x``, plain on the CPU."""
    if not x.is_cuda:
        return vae_le_dp_forward_plain(w, x, amps, var, nu_sc, sps)
    return _launch(w, x, amps, var, nu_sc, sps)


def butterfly_clocks(w, x, amps, var, nu_sc: float, sps: int) -> dict:
    """Kernel E once on CUDA tensors (the arguments of
    ``vae_le_dp_forward_fused``) with its phase clocks: {phase: clock64()
    cycles} of block 0's thread 0. For measurement only (chip_smoke.py,
    tools/); the receiver never asks for it."""
    clocks = torch.zeros(len(CLOCK_PHASES), dtype=torch.int64, device=x.device)
    _launch(w, x, amps, var, nu_sc, sps, clocks)
    return dict(zip(CLOCK_PHASES, clocks.tolist()))


def _launch(w, x, amps, var, nu_sc, sps, clocks=None):
    dev = x.device
    m, n_lev, l_in = w.shape[-1], amps.shape[0], x.shape[-1]
    n_out = (l_in + 2 * (m // 2) - m) // sps + 1
    for name, t, shape in (("w", w, (2, 4, m)), ("x", x, (2, 2, l_in)), ("amps", amps, (n_lev,)),
                           ("var", var, (2,))):
        _build.check_tensor(name, t, shape, dev)
    lib = _build.load()
    q = torch.empty((2, 2 * n_lev, n_out), dtype=torch.float32, device=dev)
    out = torch.empty((2, 2, n_out), dtype=torch.float32, device=dev)
    rc = lib.butterfly_demap_launch(n_out, m, sps, n_lev, l_in, w.data_ptr(), x.data_ptr(),
                                    amps.data_ptr(), var.data_ptr(), float(nu_sc), q.data_ptr(),
                                    out.data_ptr(), None if clocks is None else clocks.data_ptr(),
                                    _build.stream(dev))
    _build.check(rc, "butterfly_demap_launch")
    vae_le_dp_forward_fused.launches += 1
    return q, out


vae_le_dp_forward_fused.launches = 0
