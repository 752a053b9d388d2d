"""Typed experiment configurations: the DP flagship (``Eval_run_DP``), the
AWGN VAE-LE experiment (``Eval_run_shaping_vaele``), the AWGN VAE-NN
experiment (``Eval_run_vaenn``), the AWGN CMA experiment
(``Eval_run_shaping_cma``) and the LMMSE / DFE baseline
(``DFE_MQAM_shaping``).

Field-for-field the JAX package's ``utils/config.py: DpConfig,
AwgnVaeLeConfig, AwgnVaeNnConfig, AwgnCmaConfig, LmmseDfeConfig``, so one
configuration drives both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class AwgnVaeLeConfig:
    """Eval_run_shaping_vaele defaults (Eval_run_shaping_vaele.py:19-36)."""

    mod: str = "64-QAM"
    sps: int = 2
    snr_db: float = 24.0
    nu: float = 0.0
    m_est: int = 25
    lr: float = 5e-3
    batch_len: int = 350
    n_valid: int = 15000
    n_train: int = 1200
    num_epochs: int = 500
    epe: int = 2
    channel: str = "h1"


@dataclasses.dataclass(frozen=True)
class AwgnVaeNnConfig:
    """Eval_run_vaenn defaults (Eval_run_vaenn.py:19-37)."""

    mod: str = "64-QAM"
    sps: int = 2
    snr_db: float = 24.0
    m_est: int = 25
    kernel_1: int = 25
    kernel_2: int = 3
    lr: float = 4e-3
    batch_len: int = 300
    n_valid: int = 15000
    n_train: int = 4000
    num_epochs: int = 500
    epe: int = 2
    channel: str = "h1"
    batchnorm: bool = False


@dataclasses.dataclass(frozen=True)
class AwgnCmaConfig:
    """Eval_run_shaping_cma defaults (Eval_run_shaping_cma.py:19-34)."""

    mod: str = "64-QAM"
    sps: int = 2
    snr_db: float = 22.0
    nu: float = 0.0
    m_est: int = 25
    lr: float = 0.5e-4
    n_valid: int = 15000
    n_train: int = 4000
    num_epochs: int = 500
    epe: int = 2
    channel: str = "h1"
    R: float = 1.0


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


@dataclasses.dataclass(frozen=True)
class LmmseDfeConfig:
    """DFE_MQAM_shaping main-part defaults (DFE_MQAM_shaping.py:246-258)."""

    mod: str = "64-QAM"
    nu: float = 0.0270955
    channel: str = "h1"
    n_valid: int = 128000
    n_cut: int = 20
    lmmse_order: int = 20
    m_dfe: int = 11
    num_epochs: int = 5
