"""Sums over each run's samples or symbols whose result does not depend on
how many runs a tensor holds.

A float32 reduction on the card splits each output's sum over threads and
blocks by the number of outputs, so the same run's sum rounds 1 ulp apart
at 8 runs and at 4; where it feeds the channel (sigma), a kernel's input
(the CMA's power normalization) or an evaluation (SER magnitudes, MI), a
run's result would depend on the batch it shares, which run sharding
changes (``train/batching.py``). These sums accumulate in float64 and round
to float32: two float64 orders of one sum round to the same float32 unless
it lies within ~1e-14 of a rounding boundary.
"""

from __future__ import annotations

import torch

__all__ = ["run_mean", "run_sum"]


def run_sum(x: torch.Tensor, dim) -> torch.Tensor:
    """``x.sum(dim)``, accumulated in float64, as float32."""
    return torch.sum(x, dim=dim, dtype=torch.float64).to(torch.float32)


def run_mean(x: torch.Tensor, dim) -> torch.Tensor:
    """``x.mean(dim)``, accumulated in float64, as float32."""
    return torch.mean(x, dim=dim, dtype=torch.float64).to(torch.float32)
