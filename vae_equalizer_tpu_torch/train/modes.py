"""Kernel-path support matrix: which ``use_pallas`` modes each DP runner takes.

The JAX package's table (``vae_equalizer_tpu/train/modes.py``), verbatim, so
both packages accept and refuse the same modes; the port runs every mode in
the table.

Modes (the names are the JAX package's; here each kernel is a hand-written
CUDA kernel, ``ops/``):
  False    — the plain PyTorch path; always available.
  True     — the per-step kernel (kernel A for the VAE family, kernel C,
             ``ops/cma_kernel.py``, for plain CMA); sps=2, odd M.
  "frame"  — the whole-frame kernel: all of a frame's steps in one launch
             (kernel B for the VAE family, kernel D,
             ``ops/cma_frame_kernel.py``, for CMAbatch/CMAflex).
"""

from __future__ import annotations

__all__ = ["PALLAS_MODES", "check_pallas_mode"]

PALLAS_MODES: dict[str, tuple] = {
    "VAE": (False, True, "frame"),
    "VAEflex": (False, True, "frame"),
    # per-symbol CMA has no chunk structure to fuse ("frame" N/A); its
    # per-symbol recurrence kernel is mode True (ops/cma_kernel.py)
    "CMA": (False, True),
    "CMAbatch": (False, "frame"),
    "CMAflex": (False, "frame"),
}


def check_pallas_mode(loss_type: str, use_pallas) -> None:
    """Raise the documented ValueError for an unsupported kernel path."""
    allowed = PALLAS_MODES.get(loss_type)
    if allowed is None:
        raise ValueError(f"unknown loss_type {loss_type!r}")
    if use_pallas not in allowed:
        raise ValueError(
            f"use_pallas={use_pallas!r} is not supported for {loss_type} "
            f"(supported modes: {allowed}); see train/modes.py"
        )
