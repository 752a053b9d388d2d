"""Kernel L: the DP channel's elementwise and reduction work around cuFFT.

Replaces no TPU kernel: the JAX package writes the channel in plain jnp and
leaves its FFTs to XLA (``vae_equalizer_tpu/channels/optical_dp.py``). The
port's plain version, ``channels/optical_dp.py``, is ~110 small PyTorch
kernels a frame on the card; ``DpSimulator`` takes these wrappers for CUDA
tensors, with both FFTs left to cuFFT through ``torch.fft``:

* ``dp_levels`` (L1): uniforms -> PCS levels through the pmf's float32 CDF
  edges, shared or one row per run, the plain version's bits;
* ``dp_fft_input`` (L2): levels (R, 4, n_conv) -> the upsampled, zero-padded
  complex64 FFT input (R, 2, fft_len);
* ``dp_mix`` (L3): in place on the forward transform, H(theta) zf * CD per
  bin, H formed once a bin for up to 8 runs;
* ``dp_noise`` (L4, two launches): on the unnormalized inverse transform, each
  run's float64 power of the valid window, sigma, and rx = window + sigma *
  noise for the first sps * N samples.

``csrc/dp_channel_step.cuh`` says how each rounds as the plain version does
on the same device, so that levels, tx, sigma and rx are its bits (sigma but
at a float32 rounding tie of its float64 sum).
Each wrapper checks its tensors, allocates its outputs with ``torch.empty``
and launches on the current stream, so a CUDA graph captures it; each counts
its launches (``_build.counted``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = ["POWER_BLOCKS", "dp_fft_input", "dp_levels", "dp_mix", "dp_noise"]

# L4's blocks a run for the power sum (csrc/dp_channel_step.cuh: kPowerBlocks)
POWER_BLOCKS = 16


def dp_levels(u: torch.Tensor, amp0: float, steps: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """L1: the levels at uniforms ``u`` (R, ...) float32: ``amp0`` plus
    ``steps[l]`` (n_lev - 1,) for each CDF edge ``edges[..., l]`` that u
    reaches, edges (n_lev,) shared or (R, n_lev) per run."""
    dev, R = u.device, u.shape[0]
    n_lev = steps.shape[0] + 1
    _build.check_tensor("u", u, u.shape, dev)
    _build.check_tensor("steps", steps, (n_lev - 1,), dev)
    per_run = edges.dim() == 2
    _build.check_tensor("edges", edges, (R, n_lev) if per_run else (n_lev,), dev)
    out = torch.empty_like(u)
    rc = _build.load().dp_levels_launch(R, u.numel() // R, n_lev, u.data_ptr(), float(amp0),
                                        steps.data_ptr(), edges.data_ptr(), n_lev if per_run else 0,
                                        out.data_ptr(), _build.stream(dev))
    _build.check(rc, "dp_levels_launch")
    _build.count_launch(dp_levels)
    return out


def dp_fft_input(levels: torch.Tensor, sps: int, up_len: int, fft_len: int) -> torch.Tensor:
    """L2: levels (R, 4, n_conv) float32 -> complex64 (R, 2, fft_len): sample
    k of pol p the level pair (2p, 2p + 1) of symbol k / sps where sps
    divides k and k < up_len, else 0."""
    dev, (R, _, n_conv) = levels.device, levels.shape
    _build.check_tensor("levels", levels, (R, 4, n_conv), dev)
    out = torch.empty((R, 2, fft_len), dtype=torch.complex64, device=dev)
    rc = _build.load().dp_fft_input_launch(R, n_conv, sps, up_len, fft_len, levels.data_ptr(),
                                           out.data_ptr(), _build.stream(dev))
    _build.check(rc, "dp_fft_input_launch")
    _build.count_launch(dp_fft_input)
    return out


def dp_mix(z: torch.Tensor, theta: torch.Tensor, e0: tuple, e1: tuple, d0: torch.Tensor,
           d1: torch.Tensor, cd: torch.Tensor) -> torch.Tensor:
    """L3, in place: z (R, 2, fft_len) complex64 <- per bin (H z) * cd, H =
    R^T diag(d0, d1) R, R = [[ct e0, st e0], [-st e1, ct e1]] with ct, st
    the cosine and sine of ``theta`` (one float32 on z's device, read by the
    kernel, so a CUDA graph replays it with each frame's angle); e0, e1
    (re, im) floats; d0, d1, cd (fft_len,) complex64. Each complex product
    rounds as PyTorch's does on z's device: with a fused multiply-add a part
    on the card, each product alone on the host. Returns z."""
    dev, (R, _, fft_len) = z.device, z.shape
    _build.check_tensor("z", z, (R, 2, fft_len), dev, torch.complex64)
    _build.check_tensor("theta", theta.reshape(1), (1,), dev)
    for name, t in (("d0", d0), ("d1", d1), ("cd", cd)):
        _build.check_tensor(name, t, (fft_len,), dev, torch.complex64)
    rc = _build.load().dp_mix_launch(R, fft_len, theta.data_ptr(), *map(float, (*e0, *e1)),
                                     d0.data_ptr(), d1.data_ptr(), cd.data_ptr(), z.data_ptr(),
                                     int(z.is_cuda), _build.stream(dev))
    _build.check(rc, "dp_mix_launch")
    _build.count_launch(dp_mix)
    return z


def dp_noise(z: torch.Tensor, noise: torch.Tensor, *, start: int, sig_len: int, n_rx: int, sps: int,
             snr):
    """L4 (two launches): z (R, 2, fft_len) complex64, the unnormalized inverse
    transform, whose samples [start, start + sig_len) scaled by the float32
    1 / fft_len are the window; noise (R, 2, 2, sig_len) float32; ``snr`` a
    float, or (R,) float32 on z's device, per run. Returns (rx (R, 2, 2,
    n_rx), sigma (R,)): sigma = sqrt(mean(window^2) * 2 * sps / 2 / snr),
    the mean accumulated in float64 (core/reduce.py: run_mean), and rx =
    window + sigma * noise. A shared snr divides on the host and multiplies
    by its float32 reciprocal on the card, as PyTorch divides a tensor by a
    host scalar there."""
    dev, (R, _, fft_len) = z.device, z.shape
    _build.check_tensor("z", z, (R, 2, fft_len), dev, torch.complex64)
    _build.check_tensor("noise", noise, (R, 2, 2, sig_len), dev)
    snr_runs = None
    if torch.is_tensor(snr):
        _build.check_tensor("snr", snr, (R,), dev)
        snr_runs, snr, recip = snr, 0.0, 0
    elif z.is_cuda:
        snr, recip = float(np.float32(1.0) / np.float32(snr)), 1
    else:
        snr, recip = float(np.float32(snr)), 0
    partial = torch.empty((R, POWER_BLOCKS), dtype=torch.float64, device=dev)
    rx = torch.empty((R, 2, 2, n_rx), dtype=torch.float32, device=dev)
    sigma = torch.empty((R,), dtype=torch.float32, device=dev)
    rc = _build.load().dp_noise_launch(
        R, fft_len, start, sig_len, n_rx, float(np.float32(1.0 / fft_len)), z.data_ptr(),
        partial.data_ptr(), 1.0 / (4 * sig_len), sps, snr,
        None if snr_runs is None else snr_runs.data_ptr(), recip, noise.data_ptr(), rx.data_ptr(),
        sigma.data_ptr(), _build.stream(dev))
    _build.check(rc, "dp_noise_launch")
    dp_noise.launches += 2  # the power sum, then the noise pass
    return rx, sigma


for _wrapper in (dp_levels, dp_fft_input, dp_mix, dp_noise):
    _build.counted(_wrapper)
