"""A short check of kernel L (the DP channel around cuFFT) on the card, before
chip_smoke.py and the benchmark.

Builds every kernel library and prints the channel library's ptxas lines
(registers, stack, spills). Runs chip_smoke's phase 6c: kernel L against
the plain channel on the same draws at R = 8 (shared SNR), R = 40 (per-run
SNR, the SNR curve's runs) and R = 8 (per-run pmf): the bits and gaps, each
path's device time and kernels a frame. Then a 4-frame flagship experiment
looped and replayed as a CUDA graph, bit for bit, with kernel L's launches
counted (one each a frame, L4 two). With ``--parent DIR``, a checkout of the
previous commit (``git archive`` unpacked under ``build/``), it imports that
checkout's port under another name and holds this tree's channel to the
parent's on the same generator state (levels, noise and tx bit for bit,
sigma within one ulp, rx within 1e-6 of each run's rms), then times the
two in turns (parent, this tree, this tree, parent; CUDA events, the median
of each turn; then the device time and kernels a frame from torch.profiler)
at both shapes. Run from the repository root on a machine with a card:
``python tools/first_check_channel.py [--parent DIR]``.
"""

import argparse
import dataclasses
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402
from first_check_b_runs import import_port, turns  # noqa: E402
from vae_equalizer_tpu_torch.ops import _build  # noqa: E402
from vae_equalizer_tpu_torch.ops.frame_kernel import vae_dp_frame_train  # noqa: E402
from vae_equalizer_tpu_torch.train import dp as train_dp  # noqa: E402
from vae_equalizer_tpu_torch.utils import DpConfig  # noqa: E402


def ptxas_lines() -> list:
    """The channel library's ptxas lines: each kernel's properties and registers."""
    log = _build._lib_path("channel").with_suffix(".log").read_text()
    return [ln.strip() for ln in log.splitlines()
            if re.search(r"Function properties|registers|stack frame", ln)]


def graph_check(card: str) -> None:
    """A 4-frame flagship experiment of 8 runs, looped and replayed: bit for
    bit, and kernel L launched once a frame (L4 twice) in both."""
    cfg = dataclasses.replace(DpConfig(), num_frames=4)
    res = {}
    for compiled in (False, True):
        res[compiled], _ = chip_smoke._counted(
            vae_dp_frame_train, 4, lambda compiled=compiled: train_dp.train_vae_dp(
                cfg, seed=0, device="cuda", use_pallas="frame", runs=8, compiled=compiled),
            also=chip_smoke._with_eval(4))
    diff = max(chip_smoke._max_diff(res[True][k], res[False][k]) for k in res[False])
    if diff != 0.0:
        raise AssertionError(f"replayed experiment differs from the loop by {diff}")
    chip_smoke._line("L graph", ok=True, frames=4, runs=8, max_abs_diff=diff,
                     launches=chip_smoke._LAST_COUNTS, card=repr(card))


def against_parent(parent: pathlib.Path, card: str) -> None:
    """This tree's channel (kernel L) against the parent's (plain on the card)
    on the same generator state, then both timed in turns."""
    import importlib

    import_port(parent)
    p_dp = importlib.import_module("parent_port.train.dp")
    dev = torch.device("cuda")
    cfg = DpConfig()
    n_sym = cfg.n_frame_max // cfg.batch_len * cfg.batch_len
    sim = train_dp._setup(cfg, n_sym, dev)[2]
    sim_p = p_dp._setup(cfg, n_sym, dev)[2]
    theta = torch.tensor(np.float32(cfg.theta + 3 * cfg.theta_diff), device=dev)
    for label, R, per_run in chip_smoke.CHANNEL_CASES[:2]:
        snr, _ = chip_smoke._channel_inputs(cfg, R, per_run, dev)
        gens = {k: torch.Generator(device=dev) for k in ("parent", "new")}
        for g in gens.values():
            g.manual_seed(7070)
        rx, tx, sig = sim.physics(theta, *sim.draws(gens["new"], R), snr)
        rx_p, tx_p, sig_p = sim_p.physics(theta, *sim_p.draws(gens["parent"], R), snr)
        ulps = int((sig.view(torch.int32) - sig_p.view(torch.int32)).abs().max())
        rms = rx_p.square().mean(dim=(1, 2, 3)).sqrt()
        gap = float(((rx - rx_p).abs().amax(dim=(1, 2, 3)) / rms).max())
        same_tx = torch.equal(tx, tx_p)
        if not same_tx or ulps > 1 or gap > 1e-6:
            raise AssertionError(f"{label}: against the parent: tx equal {same_tx}, sigma ulps "
                                 f"{ulps}, rx gap {gap:.3g} of rms")
        frames = {"parent": lambda: sim_p.physics(theta, *sim_p.draws(gens["parent"], R), snr),
                  "new": lambda: sim.physics(theta, *sim.draws(gens["new"], R), snr)}
        t = turns(frames, reps=50)
        dev_k = {k: chip_smoke._device_kernels(fn, 20) for k, fn in frames.items()}
        chip_smoke._line(f"L vs parent {label}", ok=True, runs=R, tx_bit_identical=same_tx,
                         sigma_ulps_max=ulps, rx_gap_of_rms=f"{gap:.3g}",
                         ms_turns=",".join(f"{k}:{v[0]:.4f}/{v[1]:.4f}" for k, v in t.items()),
                         device_ms=",".join(f"{k}:{v[0]:.4f}" for k, v in dev_k.items()),
                         kernels=",".join(f"{k}:{v[1]:.1f}" for k, v in dev_k.items()),
                         card=repr(card))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _, build_s, _ = _build.build()
    _build.load()
    chip_smoke._line("L build", seconds=f"{build_s:.1f}", ptxas=repr(" | ".join(ptxas_lines())),
                     torch=torch.__version__, cuda=torch.version.cuda, card=repr(card))
    print(chip_smoke._channel_phase(card, 1), flush=True)
    graph_check(card)
    if args.parent is not None:
        against_parent(args.parent, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
