"""Stateful streaming DP receiver: block-wise equalization of a continuous stream.

Port of ``vae_equalizer_tpu/models/streaming.py: StreamingReceiver``. The
input arrives in fixed-size blocks; the receiver keeps (taps, optimizer
state, tail samples) as an explicit state, optionally adapts online (Adam
steps with optax semantics and a global step count on the block's
``block_len / adapt_batch`` back-to-back minibatches), then equalizes the
block with one overlap-save pass over ``tail || block`` (the M - 1 tail of
the previous block makes block boundaries ISI-seamless) and drops the
(M - 1) // sps warm-up symbols.

The adaptation takes one of two routes, chosen once at construction from
``use_pallas`` and the shapes (never from a failure) and exposed as
``adapt_route``:

* ``"B"``: with ``use_pallas=True`` and shapes inside kernel B's contract
  (sps 2, odd ``m_est``, ``2 adapt_batch > m_est``, at most
  ``FRAME_MAX_LEV`` levels), the block's minibatches are one frame of
  ``ops/frame_kernel.py: vae_dp_frame_train`` at R = 1 (the JAX receiver's
  ``lax.scan`` of Adam steps): one kernel-B launch per block on a CUDA
  device, B's plain version (kernel A's hand-derived step plus
  ``adam_update``) on the CPU;
* ``"autograd"``: otherwise (``use_pallas=False``, or for example sps 1,
  which the JAX receiver also accepts), a Python loop of autograd steps
  through ``vae_le_dp_forward`` + ``elbo_dp`` and ``adam_update``.

With ``use_pallas=True`` the output pass is kernel E
(``ops/butterfly_kernel.py``) on a CUDA device, its plain version on the
CPU. The receiver runs on ``device`` (default the card).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.device import resolve_device
from ..ops.butterfly_kernel import vae_le_dp_forward_fused
from ..ops.frame_kernel import adam_update, frame_opt_init, vae_dp_frame_train
from ..utils.profiling import span
from .cma import dirac_taps_dp
from .losses import elbo_dp
from .vae_le import butterfly_init, vae_le_dp_forward

__all__ = ["StreamingReceiver"]

FRAME_MAX_LEV = 16  # kernel B's level limit (csrc/dp_step.cuh: dp::MAX_LEV)


@dataclasses.dataclass
class StreamingReceiver:
    """Online DP VAE-LE receiver over fixed-size sample blocks.

    Usage::

        rxr = StreamingReceiver(amps, P, var, nu_sc, block_len=2000, adapt=True)
        state = rxr.init()
        for block in stream:                 # block: (2, 2, block_len * sps)
            state, q, out = rxr.step(state, block)
    """

    amps: Any
    P: Any
    var: Any  # (2,) demapper noise variance per pol
    nu_sc: float
    m_est: int = 25
    sps: int = 2
    block_len: int = 2000  # symbols per block
    lr: float = 2.5e-3
    adapt: bool = True
    adapt_batch: int = 100  # symbols per gradient step inside a block
    use_pallas: bool = False  # kernel E for the output pass, kernel B for the adaptation (adapt_route)
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=self.device)
        self.amps, self.P, self.var = as_t(self.amps), as_t(self.P), as_t(self.var)
        in_b = (self.sps == 2 and self.m_est % 2 == 1 and 2 * self.adapt_batch > self.m_est
                and self.amps.shape[0] <= FRAME_MAX_LEV and self.block_len >= self.adapt_batch)
        self.adapt_route = None if not self.adapt else "B" if self.use_pallas and in_b else "autograd"
        if self.adapt_route == "B":  # kernel B's R = 1 run constants, built once
            self._b_consts = (self.var[None].contiguous(), as_t([self.nu_sc]),
                              self.P[None].contiguous(), as_t([self.lr]))

    def init(self) -> dict[str, Any]:
        """Dirac taps, zero Adam moments at step 0, a zero tail."""
        params = {"w": butterfly_init(self.m_est, self.device), "h": dirac_taps_dp(self.m_est, self.device)}
        return {"params": params, "opt": {**frame_opt_init(params), "step": 0},
                "tail": torch.zeros((2, 2, self.m_est - 1), dtype=torch.float32, device=self.device)}

    def _adapt(self, params: dict, opt: dict, block: torch.Tensor):
        if self.adapt_route == "B":
            return self._adapt_b(params, opt, block)
        step = opt["step"]
        moments = {k: opt[k] for k in ("mw", "vw", "mh", "vh")}
        mb = self.adapt_batch * self.sps
        for i in range(block.shape[-1] // mb):
            x = block[..., i * mb : (i + 1) * mb]
            w_, h_ = params["w"].detach().requires_grad_(), params["h"].detach().requires_grad_()
            q, _ = vae_le_dp_forward(w_, x, self.amps, self.var, self.nu_sc, self.sps)
            loss, _ = elbo_dp(q, x, h_, self.amps, self.P)
            gw, gh = torch.autograd.grad(loss, (w_, h_))
            params, moments = adam_update(params, moments, {"w": gw, "h": gh}, self.lr, step)
            step += 1
        return params, {**moments, "step": step}

    def _adapt_b(self, params: dict, opt: dict, block: torch.Tensor):
        """The block's minibatches as one R = 1 frame of kernel B (views, no
        copies); the eval streams it also returns are not used."""
        var, nu_sc, P, lr = self._b_consts
        moments = {k: opt[k][None] for k in ("mw", "vw", "mh", "vh")}
        w, h, moments, losses, *_ = vae_dp_frame_train(
            params["w"][None], params["h"][None], moments, block[None], self.amps, var, nu_sc, P, lr,
            opt["step"], float("inf"), bl_sym=self.adapt_batch)
        return {"w": w[0], "h": h[0]}, {**{k: v[0] for k, v in moments.items()},
                                        "step": opt["step"] + losses.shape[0]}

    def adapt_block(self, state: dict, block: torch.Tensor) -> dict:
        """The adaptation part of ``step``: the state after the block's Adam steps."""
        with span("streaming.adapt"):
            params, opt = self._adapt(state["params"], state["opt"], block)
        return {**state, "params": params, "opt": opt}

    def output_block(self, state: dict, block: torch.Tensor):
        """The output part of ``step``: the overlap-save pass with the state's
        taps -> (state with the new tail, q (2, 2n, block_len), out (2, 2, block_len))."""
        with span("streaming.output"):
            x = torch.cat([state["tail"], block], dim=-1)
            w = state["params"]["w"]
            if self.use_pallas:
                q, out = vae_le_dp_forward_fused(w, x, self.amps, self.var, self.nu_sc, self.sps)
            else:
                q, out = vae_le_dp_forward(w, x, self.amps, self.var, self.nu_sc, self.sps)
            warm = (self.m_est - 1) // self.sps
            q = q[:, :, warm : warm + self.block_len]
            out = out[:, :, warm : warm + self.block_len]
            return {**state, "tail": block[:, :, -(self.m_est - 1) :]}, q, out

    def step(self, state: dict, block: torch.Tensor):
        """Process one (2, 2, block_len * sps) sample block -> (state, q, out)."""
        with span("streaming.step"):
            block = block.to(self.device, torch.float32).contiguous()
            if self.adapt:
                state = self.adapt_block(state, block)
            with torch.no_grad():
                return self.output_block(state, block)
