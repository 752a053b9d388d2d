"""Kernel L's CUDA bodies, compiled for the host.

``csrc/dp_channel_step.cuh`` compiles as plain C++ under ``VAE_HOST_EMULATION``
(``csrc/portable.cuh``); ``csrc/dp_channel_host_emulation.cpp`` runs every
index of L1-L4 in turn and each L4 power block's tree in the card's order.
The test patches ``ops/_build.py``'s ``load`` / ``stream`` to return it and
runs the channel's kernel path (``DpSimulator.draws_kernel`` /
``physics_kernel``, the wrappers of ``ops/channel_kernel.py`` with
``torch.fft`` on the CPU between them) on CPU tensors against the plain
channel (``draws_plain`` / ``physics_plain``) at the flagship frame's length
and 10 runs, at a shared SNR and pmf, a per-run SNR and a per-run pmf:
levels, noise, tx, the FFT input and H z CD bit for bit (each complex
product rounded alone, as PyTorch's CPU product; on the card one product a
part is fused, as its CUDA product is), rx within 1e-6 of each run's rms,
sigma within one float32 ulp. The ulp: PyTorch's vectorized float32 sqrt on
the CPU misrounds near-ties (~0.6 % of random inputs), where the card's
sqrtf, and L4's, round correctly; so L4 is also held, on the same inverse
transform, to the plain version's power and sigma formula with a correctly
rounded square root: sigma and rx bit for bit (its float64 sum, in another
order, moves the float32 mean only at a rounding tie). At this length the
CPU's inverse FFT applies its 1 / fft_len after the transform, as the card's
path does. It is the CPU's only check of kernel L's index arithmetic; the
card runs the same source (``chip_smoke.py`` phase 6c,
``tools/first_check_channel.py``). It skips where no C++ compiler is found.
"""

import numpy as np
import pytest
import torch

import kernel_emulation
from vae_equalizer_tpu_torch.channels import channel_ir, make_dp_simulator
from vae_equalizer_tpu_torch.core import levels_from_uniform, make_constellation
from vae_equalizer_tpu_torch.core.reduce import run_mean
from vae_equalizer_tpu_torch.ops import channel_kernel
from vae_equalizer_tpu_torch.utils import DpConfig

torch.set_num_threads(1)

N = 10000  # the flagship frame: fft_len 20160
R = 10  # two of L3's groups of 8 runs


@pytest.fixture(scope="module")
def host_lib():
    return kernel_emulation.host_lib("channel")


@pytest.fixture
def emulated(host_lib, monkeypatch):
    return kernel_emulation.emulate(monkeypatch, host_lib)


def _sim(mod: str):
    cfg = DpConfig(mod=mod)
    const = make_constellation(cfg.mod, cfg.nu)
    sim = make_dp_simulator(const, cfg.snr_db, channel_ir(cfg.channel, cfg.sps)[0], N, cfg.sps,
                            cfg.symb_rate, cfg.tau_cd, cfg.tau_pmd, np.asarray(cfg.phi_iq))
    return cfg, const, sim


@pytest.mark.parametrize("case", ["shared", "snr_per_run", "pmf_per_run"])
def test_kernel_l_matches_plain_channel(emulated, case):
    cfg, const, sim = _sim("64-QAM" if case != "pmf_per_run" else "16-QAM")
    P = snr_lin = None
    if case == "pmf_per_run":
        P = np.stack([np.asarray(make_constellation(cfg.mod, nu).P, np.float32)
                      for nu in np.linspace(0.0, 0.09, R)])
    if case == "snr_per_run":
        snr_lin = torch.from_numpy((10.0 ** (np.linspace(16.0, 25.0, R) / 10.0)).astype(np.float32))
    seed = {"shared": 3, "snr_per_run": 2**31 + 11, "pmf_per_run": 7}[case]

    levels, noise = sim.draws_plain(torch.Generator().manual_seed(seed), R, P)
    # L1 on the same uniforms (rand, then randn, from one generator)
    got, got_noise = sim.draws_kernel(torch.Generator().manual_seed(seed), R, P)
    assert torch.equal(got, levels) and torch.equal(got_noise, noise)
    u = torch.rand((R, 4, sim.n_conv), generator=torch.Generator().manual_seed(seed))
    assert torch.equal(got, levels_from_uniform(u, const.amps, const.P if P is None else P))

    z = channel_kernel.dp_fft_input(levels, sim.sps, sim.up_len, sim.fft_len)
    # the plain FFT input: fft(n=) pads the upsampled symbols with zeros
    pad = torch.nn.functional.pad(sim.upsampled_plain(levels), (0, sim.fft_len - sim.up_len))
    assert torch.equal(z, pad)

    theta = torch.tensor(np.float32(cfg.theta + 5 * cfg.theta_diff))
    rx_p, tx_p, sig_p = sim.physics_plain(theta, levels, noise, snr_lin)
    before = {w: w.launches for w in (channel_kernel.dp_fft_input, channel_kernel.dp_mix,
                                      channel_kernel.dp_noise)}
    rx, tx, sig = sim.physics_kernel(theta, levels, noise, snr_lin)
    assert {w: w.launches - n for w, n in before.items()} == {
        channel_kernel.dp_fft_input: 1, channel_kernel.dp_mix: 1, channel_kernel.dp_noise: 2}
    assert rx.shape == rx_p.shape == (R, 2, 2, 2 * N) and rx.is_contiguous()
    assert torch.equal(tx, tx_p)
    assert (sig.view(torch.int32) - sig_p.view(torch.int32)).abs().max().item() <= 1
    rms = rx_p.square().mean(dim=(1, 2, 3)).sqrt()
    gap = ((rx - rx_p).abs().amax(dim=(1, 2, 3)) / rms).max().item()
    assert gap <= 1e-6, gap

    # L4 against the plain formula on the kernel path's own inverse transform
    z = torch.fft.fft(z, dim=-1)
    want = sim.mix_plain(theta, z)
    channel_kernel.dp_mix(z, theta, *sim._e_host, sim._d0, sim._d1, sim._cd)
    assert torch.equal(z, want)
    z = torch.fft.ifft(z, dim=-1, norm="forward")[..., sim.h_len - 1 : sim.h_len - 1 + sim.sig_len]
    scale = np.float32(1.0 / sim.fft_len).item()
    window = torch.stack([z.real * scale, z.imag * scale], dim=2)
    snr = sim.snr_lin if snr_lin is None else snr_lin
    q = run_mean(window**2, (1, 2, 3)) * 2 * sim.sps / 2 / snr
    sig_ieee = torch.from_numpy(np.sqrt(q.numpy()))
    assert torch.equal(sig, sig_ieee)
    assert torch.equal(rx, (window + sig_ieee[:, None, None, None] * noise)[..., : 2 * N])
