"""Typed experiment configuration of the DP flagship (``Eval_run_DP``).

Field-for-field the JAX package's ``utils/config.py: DpConfig``, so one
configuration drives both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DpConfig:
    """Eval_run_DP defaults (Eval_run_DP.py:18-47); algorithm via ``loss_type``."""

    loss_type: str = "VAE"  # VAE | VAEflex | CMA | CMAbatch | CMAflex
    mod: str = "64-QAM"
    sps: int = 2
    snr_db: float = 23.0
    nu: float = 0.0
    m_est: int = 25
    theta: float = float(np.pi / 10)
    theta_diff: float = float(0.06 * np.pi)
    lr: float = 2.5e-3
    batch_len: int = 100
    flex_step: int = 10
    n_frame_max: int = 10000
    num_frames: int = 170
    n_lrhalf: int = 170
    channel: str = "h0"
    symb_rate: float = 90e9
    tau_cd: float = -26e-24
    tau_pmd: float = float(0.1e-12 * np.sqrt(1000))
    phi_iq: tuple[float, float] = (0.0314, 0.0314)
    n_cut: int = 10
    R: float = 1.0  # CMA modulus
