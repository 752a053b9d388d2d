"""Linear optical dual-polarization (2x2 MIMO) channel simulator.

Port of ``vae_equalizer_tpu/channels/optical_dp.py``, split into the random
draws and the deterministic physics so that tests can feed both packages the
same draws:

* ``DpSimulator.draws(gen, runs)`` -> PCS levels (R, 4, n_conv) and unit
  Gaussian noise (R, 2, 2, sig_len) from a ``torch.Generator``;
* ``DpSimulator.physics(theta, levels, noise)`` -> (rx (R, 2, 2, sps*N),
  tx (R, 2, 2, N), sigma (R,)): upsampling, one frequency-domain pass with
  the RRC pulse + ISI IR folded into the CD response, PMD, rotation theta
  with the static IQ phase, then AWGN (torch.fft, i.e. cuFFT on the card).

``draws(gen, R, P=)`` and ``physics(..., snr_lin=)`` take a per-run pmf and
SNR: the port's form of JAX's ``generate(key, theta, snr_lin_r, P_r)``.

Physics parity with the reference (optical_DP_channel/shared_funcs.py:38-90)
is inherited from the JAX package: same float64 host constants cast to
float32, same FFT length (``_fast_fft_len``, so the 'valid' window is the
same), same complex64 arithmetic order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.constellation import Constellation, sample_levels
from ..core.filters import rrcfir
from ..core.reduce import run_mean

__all__ = ["PULSE_T", "PULSE_BETA", "DpSimulator", "make_dp_simulator"]

PULSE_T = 8
PULSE_BETA = 0.1


def _fast_fft_len(n: int) -> int:
    """Smallest L >= n with L = 2^a 3^b 5^c 7^d and a >= 5 (the JAX choice).

    Kept so that both packages sample the dispersion response on the same
    grid; every such length is also a fast cuFFT size.
    """

    def ok(m):
        a = 0
        while m % 2 == 0:
            m //= 2
            a += 1
        for p in (3, 5, 7):
            while m % p == 0:
                m //= p
        return m == 1 and a >= 5

    L = n
    while not ok(L):
        L += 1
    return L


class DpSimulator:
    """One configured DP channel: fixed constants, per-call theta and draws."""

    def __init__(self, const: Constellation, snr_db: float, h_channel_up: np.ndarray,
                 N: int, sps: int, symb_rate: float, tau_cd: float, tau_pmd: float,
                 phi_iq, device="cpu"):
        self.const = const
        self.N = N
        self.sps = sps
        self.device = torch.device(device)
        h_pulse_re = rrcfir(PULSE_T, sps, PULSE_BETA)
        h_comb_c = np.convolve(h_pulse_re.astype(np.complex128), h_channel_up)
        m_up = h_channel_up.shape[-1]
        self.n_conv = N + m_up + 4 * PULSE_T
        self.up_len = sps * (self.n_conv - 1) + 1
        self.h_len = h_comb_c.shape[-1]
        self.sig_len = self.up_len - h_pulse_re.shape[-1] - m_up + 2
        self.offset = PULSE_T + m_up - 1
        self.snr_lin = 10 ** (snr_db / 10)
        self.fft_len = _fast_fft_len(self.up_len)

        # float64 host constants -> float32 planes (as the JAX package ships them)
        freq = np.fft.fftfreq(self.fft_len, 1 / symb_rate / sps)
        cd_phase = 2 * (np.pi * freq) ** 2 * tau_cd
        pmd_phase = np.pi * tau_pmd * freq
        h_f = np.fft.fft(np.pad(h_comb_c, (0, self.fft_len - self.h_len)))
        cd_c = np.exp(1j * cd_phase) * h_f
        phi = np.asarray(phi_iq, np.float64)
        f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(self.device)
        self._cd = torch.complex(f32(cd_c.real), f32(cd_c.imag))
        pmd_re, pmd_im = f32(np.cos(pmd_phase)), f32(np.sin(pmd_phase))
        self._d0 = torch.complex(pmd_re, pmd_im)
        self._d1 = torch.complex(pmd_re, -pmd_im)
        e_re, e_im = np.cos(phi).astype(np.float32), (-np.sin(phi)).astype(np.float32)
        # the static IQ phases as complex64 scalars on the device, built once: a
        # host-to-device copy per call could not be captured in a CUDA graph
        self._e0 = torch.complex(f32(e_re[0]), f32(e_im[0]))
        self._e1 = torch.complex(f32(e_re[1]), f32(e_im[1]))

    def draws(self, gen: torch.Generator, runs: int, P=None) -> tuple[torch.Tensor, torch.Tensor]:
        """(levels (R, 4, n_conv), unit noise (R, 2, 2, sig_len)) from ``gen``;
        ``P`` (R, n), a per-run sampling pmf (the sweep's nu axis batched as
        runs), else the constellation's."""
        levels = sample_levels(gen, self.const.amps, self.const.P if P is None else P,
                               (runs, 4, self.n_conv), device=self.device)
        noise = torch.randn((runs, 2, 2, self.sig_len), generator=gen, device=self.device,
                            dtype=torch.float32)
        return levels, noise

    def physics(self, theta, levels: torch.Tensor, noise: torch.Tensor, snr_lin=None):
        """Deterministic channel: (theta, levels, noise) -> (rx, tx, sigma).
        ``theta`` a float or a float32 tensor on the device (no copy: the
        runners pass their frame's row of a device table); ``snr_lin`` (R,)
        float32, a per-run linear SNR (the sweep's SNR axis batched as runs),
        else the configured one."""
        R = levels.shape[0]
        sps, dev = self.sps, self.device
        d4 = levels.reshape(R, 2, 2, self.n_conv)
        tx_up = torch.zeros((R, 2, 2, self.n_conv * sps), dtype=torch.float32, device=dev)
        tx_up[..., ::sps] = d4
        tx_up = tx_up[..., : self.up_len]
        z = torch.complex(tx_up[:, :, 0], tx_up[:, :, 1])  # (R, 2, up_len)
        zf = torch.fft.fft(z, n=self.fft_len, dim=-1)

        th = torch.as_tensor(theta, dtype=torch.float32, device=dev)
        ct, st = torch.cos(th), torch.sin(th)
        e0, e1, d0, d1, cdz = self._e0, self._e1, self._d0, self._d1, self._cd
        # H = R^T diag(d0, d1) R with R = [[ct e0, st e0], [-st e1, ct e1]]
        h00 = ct * e0 * d0 * ct * e0 + (-st * e0) * d1 * (-st * e1)
        h01 = ct * e0 * d0 * st * e0 + (-st * e0) * d1 * ct * e1
        h10 = st * e1 * d0 * ct * e0 + ct * e1 * d1 * (-st * e1)
        h11 = st * e1 * d0 * st * e0 + ct * e1 * d1 * ct * e1
        out0 = (h00 * zf[:, 0] + h01 * zf[:, 1]) * cdz
        out1 = (h10 * zf[:, 0] + h11 * zf[:, 1]) * cdz
        z = torch.fft.ifft(torch.stack([out0, out1], dim=1), dim=-1)
        z = z[..., self.h_len - 1 : self.h_len - 1 + self.sig_len]
        sig = torch.stack([z.real, z.imag], dim=2).to(torch.float32)  # (R, 2, 2, sig_len)

        snr = self.snr_lin if snr_lin is None else snr_lin
        sigma = torch.sqrt(run_mean(sig**2, (1, 2, 3)) * 2 * sps / 2 / snr)
        sig = sig + sigma[:, None, None, None] * noise
        rx = sig[..., : sps * self.N].contiguous()  # kernel B reads rows of 2N samples
        tx = levels[:, :, self.offset : self.offset + self.N].reshape(R, 2, 2, self.N)
        return rx, tx, sigma

    def __call__(self, gen: torch.Generator, theta, runs: int):
        return self.physics(theta, *self.draws(gen, runs))


def make_dp_simulator(const: Constellation, snr_db: float, h_channel_up: np.ndarray, N: int,
                      sps: int, symb_rate: float, tau_cd: float, tau_pmd: float, phi_iq,
                      device="cpu") -> DpSimulator:
    """Build the DP generator (JAX argument order, plus the device)."""
    return DpSimulator(const, snr_db, h_channel_up, N, sps, symb_rate, tau_cd, tau_pmd,
                       phi_iq, device)
