"""CMA-family helpers used by the VAE path (port of ``models/cma.py``).

Only the Dirac tap initializer is ported so far; the CMA / CMAbatch /
CMAflex equalizers themselves are later work (ROADMAP queue 1).
"""

from __future__ import annotations

import torch

__all__ = ["dirac_taps_dp"]


def dirac_taps_dp(m_est: int, device="cpu") -> torch.Tensor:
    """Dirac 2x2 complex taps (2 out-pol, 2 in-pol, 2 re/im, M): h[p, p, 0, M//2] = 1."""
    h = torch.zeros((2, 2, 2, m_est), dtype=torch.float32, device=device)
    h[0, 0, 0, m_est // 2] = 1.0
    h[1, 1, 0, m_est // 2] = 1.0
    return h
