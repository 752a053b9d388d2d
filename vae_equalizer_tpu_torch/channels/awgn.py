"""Single-polarization AWGN channel with static complex ISI.

Port of ``vae_equalizer_tpu/channels/awgn.py: make_awgn_simulator``, split
into the random draws and the deterministic physics so that tests can feed
both packages the same draws:

* ``AwgnSimulator.draws(gen, runs)`` -> PCS levels (*runs, 2, n_conv) and
  unit Gaussian noise (*runs, 2, sig_len) from a ``torch.Generator``;
* ``AwgnSimulator.physics(levels, noise)`` -> (rx (*runs, 2, sps*N),
  tx (*runs, 2, N), sigma (*runs)): zero-insertion upsampling, the RRC (or
  RC) pulse convolved with the channel IR into one complex filter, the
  'valid' complex convolution (one torch.fft pass, cuFFT on the card: the
  circular convolution of length >= up_len equals the linear one on the
  'valid' window), AWGN with the power-measured sigma
  sqrt(sps mean|rx|^2 / 2 / snr) or the fixed sqrt(1/2) / 10^(SNR/20)
  (``fixed_noise``, the VAE-NN convention), and the ground truth at offset
  T + m_orig - 1.

``runs`` may be an int or a tuple: every leading dim is a batch of
independent frames (the frame-mode experiment draws all runs x epochs at
once).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.constellation import Constellation, sample_levels
from ..core.filters import rcfir, rrcfir
from ..core.reduce import run_mean
from .optical_dp import PULSE_BETA, PULSE_T, _fast_fft_len

__all__ = ["AwgnSimulator", "make_awgn_simulator"]


class AwgnSimulator:
    """One configured AWGN-ISI frame generator: fixed constants, per-call draws."""

    def __init__(self, const: Constellation, snr_db: float, h_channel_up: np.ndarray, m_orig: int,
                 N: int, sps: int, *, pulse: str = "rrc", fixed_noise: bool = False, device="cpu"):
        self.const = const
        self.N = N
        self.sps = sps
        self.device = torch.device(device)
        pulse_fn = rrcfir if pulse == "rrc" else rcfir
        h_pulse_re = pulse_fn(PULSE_T, sps, PULSE_BETA)
        # pulse and channel IR as one complex filter, complex64 as in JAX
        h_comb_c = np.convolve(h_pulse_re.astype(np.complex64), h_channel_up)
        self.n_conv = N + h_channel_up.shape[-1] + 4 * PULSE_T
        self.up_len = sps * (self.n_conv - 1) + 1
        self.h_len = h_comb_c.shape[-1]
        self.sig_len = self.up_len - self.h_len + 1
        self.offset = PULSE_T + m_orig - 1
        self.snr_lin = 10 ** (snr_db / 10)
        self.fixed_noise = fixed_noise
        self.sigma_fixed = float(np.float32(np.sqrt(1 / 2) / 10 ** (snr_db / 20)))
        self.fft_len = _fast_fft_len(self.up_len)
        h = torch.complex(torch.from_numpy(h_comb_c.real.astype(np.float32)),
                          torch.from_numpy(h_comb_c.imag.astype(np.float32))).to(self.device)
        self._hf = torch.fft.fft(h, n=self.fft_len)

    def draws(self, gen: torch.Generator, runs) -> tuple[torch.Tensor, torch.Tensor]:
        """(levels (*runs, 2, n_conv), unit noise (*runs, 2, sig_len)) from ``gen``."""
        prefix = (runs,) if isinstance(runs, int) else tuple(runs)
        levels = sample_levels(gen, self.const.amps, self.const.P, prefix + (2, self.n_conv),
                               device=self.device)
        noise = torch.randn(prefix + (2, self.sig_len), generator=gen, device=self.device,
                            dtype=torch.float32)
        return levels, noise

    def physics(self, levels: torch.Tensor, noise: torch.Tensor):
        """Deterministic channel: (levels, noise) -> (rx, tx, sigma)."""
        batch = levels.shape[:-2]
        sps = self.sps
        tx_up = torch.zeros(batch + (2, self.n_conv * sps), dtype=torch.float32, device=levels.device)
        tx_up[..., ::sps] = levels
        z = torch.complex(tx_up[..., 0, : self.up_len], tx_up[..., 1, : self.up_len])
        y = torch.fft.ifft(torch.fft.fft(z, n=self.fft_len) * self._hf)
        y = y[..., self.h_len - 1 : self.h_len - 1 + self.sig_len]
        rx = torch.stack([y.real, y.imag], dim=-2).to(torch.float32)  # (*batch, 2, sig_len)
        if self.fixed_noise:
            sigma = torch.full(batch, self.sigma_fixed, dtype=torch.float32, device=rx.device)
        else:
            power = run_mean(rx[..., 0, :] ** 2 + rx[..., 1, :] ** 2, -1)
            sigma = torch.sqrt(sps * power / 2 / self.snr_lin)
        rx = rx + sigma[..., None, None] * noise
        tx = levels[..., self.offset : self.offset + self.N]
        return rx[..., : sps * self.N].contiguous(), tx, sigma

    def __call__(self, gen: torch.Generator, runs):
        return self.physics(*self.draws(gen, runs))


def make_awgn_simulator(const: Constellation, snr_db: float, h_channel_up: np.ndarray, m_orig: int,
                        N: int, sps: int, *, pulse: str = "rrc", fixed_noise: bool = False,
                        device="cpu") -> AwgnSimulator:
    """Build the AWGN generator (JAX argument order, plus the device)."""
    return AwgnSimulator(const, snr_db, h_channel_up, m_orig, N, sps, pulse=pulse,
                         fixed_noise=fixed_noise, device=device)
