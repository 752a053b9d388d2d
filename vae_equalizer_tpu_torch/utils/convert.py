"""Carry weights, CMA taps and optimizer state over from the JAX package.

The port keeps the JAX package's public layouts — DP ``w`` (..., 2, 4, M),
``h`` and the CMA taps (..., 2, 2, 2, M), SISO ``w`` (..., 1, 2, M) and
``h`` (..., 2, M), the optimizer moments in the same shapes — so a
conversion is a checked copy: float32, on the requested device, with the
shapes the port expects.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["amsgrad_state_from_jax", "params_from_jax", "opt_from_jax", "siso_params_from_jax",
           "taps_from_jax"]


def _copy(name: str, a, tail: tuple[int, ...], device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype != np.float32:
        raise TypeError(f"{name}: expected float32, got {arr.dtype}")
    if arr.ndim < len(tail) or arr.shape[arr.ndim - len(tail):] != tail:
        raise ValueError(f"{name}: expected shape (..., {', '.join(map(str, tail))}), got {arr.shape}")
    return torch.from_numpy(arr.copy()).to(device)


def params_from_jax(params: dict, device="cpu") -> dict[str, torch.Tensor]:
    """{"w": (..., 2, 4, M), "h": (..., 2, 2, 2, M)} arrays -> torch tensors."""
    m = np.asarray(params["w"]).shape[-1]
    w = _copy("w", params["w"], (2, 4, m), device)
    h = _copy("h", params["h"], (2, 2, 2, m), device)
    if w.shape[:-3] != h.shape[:-4]:
        raise ValueError(f"w and h disagree on the runs prefix: {tuple(w.shape)} vs {tuple(h.shape)}")
    return {"w": w, "h": h}


def opt_from_jax(opt: dict, device="cpu") -> dict[str, torch.Tensor]:
    """Adam moments {"mw", "vw", "mh", "vh"} (frame-kernel layout) -> torch."""
    m = np.asarray(opt["mw"]).shape[-1]
    out = {k: _copy(k, opt[k], (2, 4, m), device) for k in ("mw", "vw")}
    out.update({k: _copy(k, opt[k], (2, 2, 2, m), device) for k in ("mh", "vh")})
    return out


def taps_from_jax(h, device="cpu") -> torch.Tensor:
    """CMA taps (..., 2, 2, 2, M) float32 (e.g. ``run_cma_dp``'s "taps") ->
    a torch tensor, to seed ``run_cma_dp(taps_init=...)``."""
    return _copy("taps", h, (2, 2, 2, np.asarray(h).shape[-1]), device)


def siso_params_from_jax(params: dict, device="cpu") -> dict[str, torch.Tensor]:
    """SISO VAE-LE {"w": (..., 1, 2, M), "h": (..., 2, M)} arrays -> torch tensors."""
    m = np.asarray(params["w"]).shape[-1]
    w = _copy("w", params["w"], (1, 2, m), device)
    h = _copy("h", params["h"], (2, m), device)
    if w.shape[:-3] != h.shape[:-2]:
        raise ValueError(f"w and h disagree on the runs prefix: {tuple(w.shape)} vs {tuple(h.shape)}")
    return {"w": w, "h": h}


def amsgrad_state_from_jax(state, device="cpu") -> tuple[dict[str, torch.Tensor], int]:
    """``optax.amsgrad`` state over SISO params {"w", "h"} (its
    ``ScaleByAmsgradState`` mu / nu / nu_max, alone or first in the chain
    tuple) -> (moments {"mw","vw","xw","mh","vh","xh"} for
    ``ops/siso_frame_kernel.py``, the step count = the next update's step0)."""
    if not hasattr(state, "nu_max"):
        state = state[0]
    moments = {}
    for key, tree in (("m", state.mu), ("v", state.nu), ("x", state.nu_max)):
        p = siso_params_from_jax(tree, device)
        moments[key + "w"], moments[key + "h"] = p["w"], p["h"]
    return moments, int(np.asarray(state.count))
