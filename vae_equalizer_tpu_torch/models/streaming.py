"""Stateful streaming DP receiver: block-wise equalization of a continuous stream.

Port of ``vae_equalizer_tpu/models/streaming.py: StreamingReceiver``. The
input arrives in fixed-size blocks; the receiver keeps (taps, optimizer
state, tail samples) as an explicit state, optionally adapts online (Adam
steps on the block's minibatches, autograd through ``vae_le_dp_forward`` +
``elbo_dp``, optax semantics with a global step count), then equalizes the
block with one overlap-save pass over ``tail || block`` (the M - 1 tail of
the previous block makes block boundaries ISI-seamless) and drops the
(M - 1) // sps warm-up symbols.

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
from ..ops.frame_kernel import adam_update, frame_opt_init
from .cma import dirac_taps_dp
from .losses import elbo_dp
from .vae_le import butterfly_init, vae_le_dp_forward

__all__ = ["StreamingReceiver"]


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
    use_pallas: bool = False  # kernel E for the output pass
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=self.device)
        self.amps, self.P, self.var = as_t(self.amps), as_t(self.P), as_t(self.var)

    def init(self) -> dict[str, Any]:
        """Dirac taps, zero Adam moments at step 0, a zero tail."""
        params = {"w": butterfly_init(self.m_est, self.device), "h": dirac_taps_dp(self.m_est, self.device)}
        return {"params": params, "opt": {**frame_opt_init(params), "step": 0},
                "tail": torch.zeros((2, 2, self.m_est - 1), dtype=torch.float32, device=self.device)}

    def _adapt(self, params: dict, opt: dict, block: torch.Tensor):
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

    def adapt_block(self, state: dict, block: torch.Tensor) -> dict:
        """The adaptation part of ``step``: the state after the block's Adam steps."""
        params, opt = self._adapt(state["params"], state["opt"], block)
        return {**state, "params": params, "opt": opt}

    def output_block(self, state: dict, block: torch.Tensor):
        """The output part of ``step``: the overlap-save pass with the state's
        taps -> (state with the new tail, q (2, 2n, block_len), out (2, 2, block_len))."""
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
        block = block.to(self.device, torch.float32).contiguous()
        if self.adapt:
            state = self.adapt_block(state, block)
        with torch.no_grad():
            return self.output_block(state, block)
