"""A short first check of kernel A's runs axis and kernel B's stride form on
the card, before chip_smoke.py.

Builds every kernel library and prints the dp library's ptxas lines; runs
kernel A on one minibatch of R = 8 runs, read in place from the frame rows,
against its plain version and times it; runs kernel B with stride_sym = 10
(VAEflex) over 3 windows against its plain version and times one whole
990-window frame; then times 3 frames of train_vae_dp(use_pallas=True).
Run from the repository root on a machine with a card:
``PYTHONPATH=. python tools/first_check_a_b.py``.
"""

import dataclasses
import subprocess
import time

import numpy as np
import torch

from vae_equalizer_tpu_torch.models import butterfly_init, dirac_taps_dp
from vae_equalizer_tpu_torch.ops import _build
from vae_equalizer_tpu_torch.ops.elbo_kernel import vae_dp_loss_and_grad, vae_dp_loss_and_grad_plain
from vae_equalizer_tpu_torch.ops.frame_kernel import (
    frame_opt_init,
    vae_dp_frame_train,
    vae_dp_frame_train_plain,
)
from vae_equalizer_tpu_torch.train import dp as train_dp
from vae_equalizer_tpu_torch.utils import DpConfig

NAMES_A = ("loss", "var_est", "gw", "gh", "q", "out")
NAMES_B = ("w", "h", "opt", "losses", "var_est", "out", "dec", "eq", "mm", "s1")


def err(got, want) -> str:
    """Max abs error / scale."""
    return f"{(got - want).abs().max().item():.2e}/{want.abs().max().item():.2e}"


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), torch.__version__, torch.version.cuda, flush=True)
    _, dt, log = _build.build()
    print("build s", f"{dt:.1f}", flush=True)
    for ln in log.splitlines():
        if "vae_dp" in ln or "registers" in ln:
            print("  ", ln.strip()[:200])
    _build.load()
    dev = torch.device("cuda")
    cfg = DpConfig()
    R, M, bl, fs = 8, cfg.m_est, cfg.batch_len, cfg.flex_step
    const, var, sim, amps, P = train_dp._setup(cfg, 10000, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    rx, _, _ = sim(gen, float(np.float32(cfg.theta)), R)
    w = butterfly_init(M, dev) + 0.01 * torch.randn((R, 2, 4, M), generator=gen, device=dev)
    h = dirac_taps_dp(M, dev) + 0.01 * torch.randn((R, 2, 2, 2, M), generator=gen, device=dev)

    a_args = (w, h, rx[..., 2 * bl : 4 * bl], amps, var, const.nu_sc, P)
    got = vae_dp_loss_and_grad(*a_args)
    torch.cuda.synchronize()
    want = vae_dp_loss_and_grad_plain(*a_args)
    print("A R=8", {n: err(g, wa) for n, g, wa in zip(NAMES_A, got, want)}, flush=True)
    for _ in range(3):
        vae_dp_loss_and_grad(*a_args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        vae_dp_loss_and_grad(*a_args)
    torch.cuda.synchronize()
    print(f"A R=8 per launch (host clock over 100) {10 * (time.perf_counter() - t0):.4f} ms", flush=True)

    opt = frame_opt_init({"w": w, "h": h})
    b_args = (w, h, opt, rx[..., : 2 * (3 * fs + bl)].contiguous(), amps, var, const.nu_sc, P,
              cfg.lr, 40, 41.0)
    got = vae_dp_frame_train(*b_args, bl_sym=bl, stride_sym=fs)
    torch.cuda.synchronize()
    want = vae_dp_frame_train_plain(*b_args, bl_sym=bl, stride_sym=fs)
    print("B stride 3 windows", tuple(got[3].shape),
          {n: err(g, wa) for n, g, wa in zip(NAMES_B, got, want) if n not in ("opt", "dec")},
          "dec", float((got[6] == want[6]).float().mean()), flush=True)
    f_args = (w, h, opt, rx, amps, var, const.nu_sc, P, cfg.lr, 0, 1e9)
    vae_dp_frame_train(*f_args, bl_sym=bl, stride_sym=fs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = vae_dp_frame_train(*f_args, bl_sym=bl, stride_sym=fs)
    torch.cuda.synchronize()
    print("B stride frame", tuple(out[3].shape), f"{1e3 * (time.perf_counter() - t0):.3f} ms", flush=True)

    cfg3 = dataclasses.replace(cfg, num_frames=3)
    for mode in (True, False):
        vae_dp_loss_and_grad.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train_dp.train_vae_dp(cfg3, 0, device="cuda", runs=R, use_pallas=mode)
        torch.cuda.synchronize()
        print("train_vae_dp", mode, f"{(time.perf_counter() - t0) / 3 * 1e3:.1f} ms per frame",
              "A launches", vae_dp_loss_and_grad.launches, "soft SER", res["ser"][:, 2:].mean((0, 1)),
              flush=True)


if __name__ == "__main__":
    main()
