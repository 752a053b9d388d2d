"""A short first check of kernels H and E on the card, before chip_smoke.py.

Builds every kernel library and prints the ptxas lines; runs kernel H (R = 8,
the full VAE-NN width, Net and Net_BN) for 2 epochs against its plain engine
and times it over 20 epochs (and the plain engine over 2); then kernel E at
the streaming shapes (sps 2 and 1) against its plain version. Run from the
repository root on a machine with a card:
``python tools/first_check_h_e.py``.
"""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from vae_equalizer_tpu_torch.core import make_constellation
from vae_equalizer_tpu_torch.models import butterfly_init
from vae_equalizer_tpu_torch.models.vae_nn import vae_nn_init
from vae_equalizer_tpu_torch.ops import _build
from vae_equalizer_tpu_torch.ops import nn_frame_kernel as nfk
from vae_equalizer_tpu_torch.ops.butterfly_kernel import vae_le_dp_forward_fused, vae_le_dp_forward_plain

NAMES = ["w1f", "w2f", "h", "bnp", "rs", "opt", "losses", "w1_ev", "w2_ev", "h_ev", "bnp_ev", "rs_ev"]


def errs(got, want) -> dict:
    """Max abs error / scale of every tensor output, and the losses' max relative error."""
    out = {n: f"{(g - w).abs().max().item():.2e}/{w.abs().max().item():.2e}"
           for n, g, w in zip(NAMES, got, want) if not isinstance(g, dict)}
    out["loss_rel"] = f"{((got[6] - want[6]).abs() / want[6].abs()).max().item():.2e}"
    return out


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), torch.__version__, torch.version.cuda, flush=True)
    _, dt, log = _build.build()
    print("build s", dt, flush=True)
    for ln in log.splitlines():
        if "nn_" in ln or "butterfly" in ln or "registers" in ln:
            print("  ", ln.strip()[:200])
    _build.load()
    dev = torch.device("cuda")
    const = make_constellation("64-QAM", 0.0)
    amps = torch.from_numpy(const.amps.astype(np.float32)).to(dev)
    R, M, k1, bl, nb, ch = 8, 25, 25, 300, 13, 16
    kw = dict(bl_sym=bl, n_batches=nb, epe=2, k1=k1)
    for bn_on in (False, True):
        gen = torch.Generator()
        gen.manual_seed(1)
        net, _ = vae_nn_init(gen, k1, 3, const.num_lev, bn_on)
        w1f, w2f = nfk.flatten_nn_params(net)
        w1f = (w1f.expand(R, *w1f.shape) + 0.01 * torch.randn((R,) + w1f.shape, generator=gen))
        w1f, w2f = w1f.contiguous().to(dev), w2f.expand(R, *w2f.shape).contiguous().to(dev)
        h = torch.zeros(R, 2, M)
        h[:, 0, M // 2] = 1
        h = (h + 0.01 * torch.randn(h.shape, generator=gen)).to(dev)
        bn = None
        if bn_on:
            bn = (torch.stack([torch.ones(R, ch), torch.zeros(R, ch)], -1).contiguous().to(dev),
                  torch.stack([torch.zeros(R, ch), torch.ones(R, ch)], -1).contiguous().to(dev))
        opt = nfk.nn_frame_opt_init(w1f, w2f, h, None if bn is None else bn[0])
        variant = "bn" if bn_on else "net"
        rx = (0.5 * torch.randn((R, 2, 2, 8000), generator=gen)).to(dev)
        got = nfk.vae_nn_experiment_train(w1f, w2f, h, opt, rx, amps, 4e-3, bn, 0.1, **kw)
        torch.cuda.synchronize()
        want = nfk.vae_nn_experiment_train_plain(w1f, w2f, h, opt, rx, amps, 4e-3, bn, 0.1, **kw)
        print("H", variant, "2 epochs", json.dumps(errs(got, want)), flush=True)
        rx20 = (0.5 * torch.randn((R, 20, 2, 8000), generator=gen)).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nfk.vae_nn_experiment_train(w1f, w2f, h, opt, rx20, amps, 4e-3, bn, 0.1, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        print("H", variant, f"20 epochs {1e3 * (t1 - t0):.1f} ms, per step {1e3 * (t1 - t0) / 260:.4f} ms",
              flush=True)
        t0 = time.perf_counter()
        nfk.vae_nn_experiment_train_plain(w1f, w2f, h, opt, rx20[:, :2], amps, 4e-3, bn, 0.1, **kw)
        torch.cuda.synchronize()
        print("plain", f"2 epochs per step {1e3 * (time.perf_counter() - t0) / 26:.3f} ms", flush=True)

    for sps, length in ((2, 4024), (1, 2024)):
        g = torch.Generator(device=dev)
        g.manual_seed(3)
        w = (butterfly_init(25, dev) + 0.05 * torch.randn((2, 4, 25), generator=g, device=dev)).contiguous()
        x = torch.randn((2, 2, length), generator=g, device=dev)
        var = torch.tensor([0.01, 0.012], device=dev)
        q, o = vae_le_dp_forward_fused(w, x, amps, var, 0.0, sps)
        torch.cuda.synchronize()
        qp, op = vae_le_dp_forward_plain(w, x, amps, var, 0.0, sps)
        print("E sps", sps, tuple(q.shape), "q err", (q - qp).abs().max().item(), "out err",
              (o - op).abs().max().item(), flush=True)
    print("launches", nfk.vae_nn_experiment_train.launches, vae_le_dp_forward_fused.launches)


if __name__ == "__main__":
    main()
