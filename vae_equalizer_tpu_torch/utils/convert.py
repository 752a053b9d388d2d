"""Carry weights, CMA taps and optimizer state over from the JAX package.

The port keeps the JAX package's public layouts — DP ``w`` (..., 2, 4, M),
``h`` and the CMA taps (..., 2, 2, 2, M), SISO ``w`` (..., 1, 2, M) and
``h`` (..., 2, M), the VAE-NN filters in torch's Conv1d layout, the
optimizer moments in the same shapes — so a conversion is a checked copy:
float32, on the requested device, with the shapes the port expects. The
VAE-NN's AMSGrad moments go to kernel H's flat layout
(``ops/nn_frame_kernel.py: flatten_nn_params``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["amsgrad_state_from_jax", "nn_amsgrad_state_from_jax", "nn_params_from_jax",
           "opt_from_jax", "params_from_jax", "siso_params_from_jax", "taps_from_jax"]


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


def opt_from_jax(opt, device="cpu"):
    """Adam state of the JAX package -> torch moments {"mw", "vw", "mh", "vh"}
    in the shapes of w (..., 2, 4, M) and h (..., 2, 2, 2, M).

    ``opt`` is either the frame kernel's moments dict (``frame_opt_init``
    layout), returned as that dict, or the per-step path's optax state
    (``train/dp.py: _vae_optimizer``, a ``multi_transform`` of one Adam per
    parameter group, with or without a runs axis), returned as (moments, the
    step count = the next update's step for ``adam_update``)."""
    if isinstance(opt, dict):
        m = np.asarray(opt["mw"]).shape[-1]
        out = {k: _copy(k, opt[k], (2, 4, m), device) for k in ("mw", "vw")}
        out.update({k: _copy(k, opt[k], (2, 2, 2, m), device) for k in ("mh", "vh")})
        return out
    moments, counts = {}, set()
    for group in ("w", "h"):
        adam = _find_state(opt.inner_states[group], "mu")
        if adam is None:
            raise ValueError(f"no optax Adam state (mu / nu) for the {group!r} group")
        moments["m" + group], moments["v" + group] = adam.mu[group], adam.nu[group]
        counts.update(np.asarray(adam.count).reshape(-1).tolist())
    if len(counts) != 1:
        raise ValueError(f"the Adam step counts disagree: {sorted(counts)}")
    return opt_from_jax(moments, device), int(counts.pop())


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


def nn_params_from_jax(params: dict, bn_state=None, device="cpu") -> dict:
    """VAE-NN {"net": {"w1" (.., C, 2, k1), "b1", "w2" (.., C, C, k2), "b2"[,
    "bn_scale", "bn_bias"]}, "h" (.., 2, M)[, "bn"]} arrays -> torch, with the
    BatchNorm state {"mean", "var", "momentum"} (``bn_state``, else
    ``params["bn"]``) as "bn" where there is one."""
    net = params["net"]
    ch, k1 = np.asarray(net["w1"]).shape[-3], np.asarray(net["w1"]).shape[-1]
    k2 = np.asarray(net["w2"]).shape[-1]
    tails = {"w1": (ch, 2, k1), "w2": (ch, ch, k2)}
    out = {"net": {k: _copy(k, v, tails.get(k, (ch,)), device) for k, v in net.items()},
           "h": _copy("h", params["h"], (2, np.asarray(params["h"]).shape[-1]), device)}
    bn_state = bn_state if bn_state is not None else params.get("bn")
    if bn_state is not None:
        out["bn"] = {"mean": _copy("mean", bn_state["mean"], (ch,), device),
                     "var": _copy("var", bn_state["var"], (ch,), device),
                     "momentum": float(bn_state["momentum"])}
    return out


def _find_state(state, attr: str):
    """The first optax state with field ``attr`` inside ``state`` (a chain
    tuple, a masked state, or ``multi_transform``'s inner states):
    "nu_max" finds the AMSGrad state, "mu" the Adam state."""
    if hasattr(state, attr):
        return state
    children = state.values() if isinstance(state, dict) else (
        state if isinstance(state, tuple) else vars(state).values() if hasattr(state, "__dict__")
        else ())
    for child in children:
        found = _find_state(child, attr)
        if found is not None:
            return found
    return None


def nn_amsgrad_state_from_jax(state, device="cpu") -> tuple[dict[str, torch.Tensor], int]:
    """``optax.amsgrad`` state over VAE-NN params {"net", "h"} (alone, in a
    chain, or the "train" part of Net_BN's ``multi_transform``) -> (moments
    {"m1","v1","x1","m2",...,"xb"} in kernel H's flat layout, the step count
    = the next update's step0)."""
    from ..ops.nn_frame_kernel import flatten_nn_params

    ams = _find_state(state, "nu_max")
    if ams is None:
        raise ValueError("no optax AMSGrad state (mu / nu / nu_max) found")
    moments = {}
    for key, tree in (("m", ams.mu), ("v", ams.nu), ("x", ams.nu_max)):
        p = nn_params_from_jax({"net": tree["net"], "h": tree["h"]}, device=device)
        net = p["net"]
        moments[key + "1"], moments[key + "2"] = flatten_nn_params(net)
        moments[key + "h"] = p["h"]
        moments[key + "b"] = (torch.stack([net["bn_scale"], net["bn_bias"]], dim=-1)
                              if "bn_scale" in net else
                              torch.zeros(moments[key + "1"].shape[:-1] + (2,), device=device))
    return {k: v.contiguous() for k, v in moments.items()}, int(np.asarray(ams.count))
