"""First check of run sharding on the card: build the kernels, then hold the
path's per-run operations at R runs against the same operations on each
half of the runs (the batch sizes that two ranks see) and print the max abs
diff of each (asserting nothing: the probes name any operation whose
rounding depends on the number of runs), then run chip_smoke.py's phase 5
(the unsharded flagship) and phase 34 (every runner under a mesh of two
gloo ranks sharing the card, held to its unsharded run bit for bit) alone.

    PYTHONPATH=. python tools/first_check_run_sharding.py

About 2 minutes of command on the card; exits non-zero if phase 34 fails.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke
from vae_equalizer_tpu_torch.ops import _build


def _diff(a, b) -> float:
    if isinstance(a, dict):
        return max((_diff(a[k], b[k]) for k in a), default=0.0)
    if isinstance(a, torch.Tensor):
        return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
    if isinstance(a, np.ndarray):
        return float(np.abs(a.astype(np.float64) - b).max()) if a.size else 0.0
    return 0.0 if a == b else float("inf")


def _halves(fn, *full_args, R: int):
    """max abs diff of fn on all R runs against fn on each half, joined."""
    whole = fn(*full_args)
    parts = [fn(*(a[lo:hi] if torch.is_tensor(a) and a.dim() and a.shape[0] == R else a
                  for a in full_args)) for lo, hi in ((0, R // 2), (R // 2, R))]
    whole = whole if isinstance(whole, tuple) else (whole,)
    parts = [p if isinstance(p, tuple) else (p,) for p in parts]
    return [_diff(w, torch.cat([p[i] for p in parts])) for i, w in enumerate(whole)]


def main() -> int:
    if not torch.cuda.is_available():
        print("first_check_run_sharding: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vae_equalizer_tpu_torch.core.reduce import run_mean
    from vae_equalizer_tpu_torch.models import butterfly_init, dirac_taps_dp
    from vae_equalizer_tpu_torch.ops.frame_kernel import frame_opt_init, vae_dp_frame_train
    from vae_equalizer_tpu_torch.train import awgn as train_awgn
    from vae_equalizer_tpu_torch.train import dp as train_dp
    from vae_equalizer_tpu_torch.train.eval_utils import BatchCutWeight
    from vae_equalizer_tpu_torch.utils import AwgnVaeLeConfig, DpConfig

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t_all = time.perf_counter()
    _, build_s, _ = _build.build()
    _build.load()
    chip_smoke._line("build", seconds=f"{build_s:.1f}", torch=torch.__version__)
    dev = torch.device("cuda")

    # ---- per-run operations at R against each half
    cfg = DpConfig()
    n_sym = cfg.n_frame_max // cfg.batch_len * cfg.batch_len
    const, var, sim, amps, P = train_dp._setup(cfg, n_sym, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    R = 8
    lev, noi = sim.draws(g, R)
    theta = torch.tensor(0.1, device=dev)
    chip_smoke._line("probe dp physics", rx_sigma_tx=_halves(
        lambda a, b: sim.physics(theta, a, b), lev, noi, R=R))
    sig = torch.randn((R, 2, 2, sim.sig_len), generator=g, device=dev)
    chip_smoke._line("probe dp mean", float32=_halves(
        lambda s: torch.mean(s ** 2, dim=(1, 2, 3)), sig, R=R), float64_sum=_halves(
        lambda s: run_mean(s ** 2, (1, 2, 3)), sig, R=R))
    z = torch.complex(sig[:, :, 0], sig[:, :, 1])
    chip_smoke._line("probe dp fft", diff=_halves(
        lambda s: torch.view_as_real(torch.fft.fft(s, n=sim.fft_len, dim=-1)), z, R=R))
    ve = torch.rand((R, 100, 2), generator=g, device=dev)
    chip_smoke._line("probe var_est mean", cumsum=_halves(
        lambda v: v.cumsum(dim=-2)[..., -1, :], ve, R=R), mean=_halves(
        lambda v: v.mean(dim=-2), ve, R=R))

    # the evaluation of one kernel-B frame, column by column of its packed metrics
    rx, tx, sigma = sim.physics(theta, lev, noi)
    w0 = butterfly_init(cfg.m_est, dev).expand((R, 2, 4, cfg.m_est)).contiguous()
    h0 = dirac_taps_dp(cfg.m_est, dev).expand((R, 2, 2, 2, cfg.m_est)).contiguous()
    k = vae_dp_frame_train(w0, h0, frame_opt_init({"w": w0, "h": h0}), rx, amps, var, const.nu_sc,
                           P, cfg.lr, 0, 1e9, bl_sym=cfg.batch_len)
    m_max = n_sym // cfg.batch_len
    wfn = BatchCutWeight(m_max, cfg.batch_len, cfg.n_cut)

    def evaluate(sl):
        losses, var_est, out, dec, eq, mm, s1 = (a[:, sl] for a in k[3:10])
        return train_dp._finish_vae_frame(losses, out, var_est, tx[sl], amps, P, var, const.nu_sc,
                                          const.pow_mean, wfn, sigma[sl], dec, eq, mm, s1)

    whole = evaluate(slice(None))
    halves = torch.cat([evaluate(slice(0, R // 2)), evaluate(slice(R // 2, R))])
    cols = (whole - halves).abs().max(dim=0).values.tolist()
    names = [f"{n}{i}" for n, w in train_dp._VAE_FIELDS for i in range(w)]
    chip_smoke._line("probe frame eval", **{n: c for n, c in zip(names, cols)})

    acfg = AwgnVaeLeConfig()
    _, sims, _, _, _ = train_awgn._setup(acfg, dev)
    Ra, E = 20, 50
    la, na = sims["train"].draws(g, (Ra, E))
    chip_smoke._line("probe awgn physics", rx_tx_sigma=_halves(sims["train"].physics, la, na, R=Ra))
    la, na = sims["train"].draws(g, Ra)  # one epoch's frames, the loop modes' batch
    chip_smoke._line("probe awgn epoch physics", rx_tx_sigma=_halves(sims["train"].physics, la, na,
                                                                     R=Ra))

    # ---- phase 5's flagship (the unsharded reference), then phase 34
    res, wall = chip_smoke._counted(vae_dp_frame_train, cfg.num_frames,
                                    lambda: train_dp.train_vae_dp(cfg, seed=0, device="cuda",
                                                                  use_pallas="frame", runs=R),
                                    also=chip_smoke._with_eval(cfg.num_frames))
    chip_smoke._line("5 main path", wall_s=f"{wall:.3f}",
                     soft_ser_last20=f"{float(res['ser'][:, 2:, -20:].mean()):.5f}")
    chip_smoke._run_sharding_phases(card, res, wall)
    print(f"{card} total_s={time.perf_counter() - t_all:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
