"""Shared CLI plumbing for the sweep drivers (port of
``vae_equalizer_tpu/drivers/_common.py``)."""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..core import resolve_device
from ..utils import io


def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--quick", action="store_true", help="tiny smoke-test workload")
    p.add_argument("--iters", type=int, default=None, help="independent runs per grid point")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="results")
    p.add_argument("--device", default="cuda",
                   help="cuda (the hand-written kernels) or cpu (their plain PyTorch versions)")
    p.add_argument("--no-mesh", action="store_true",
                   help="accepted for the JAX CLI's sake; one card has no mesh to shard over")
    p.add_argument("--verbose", action="store_true", help="print per-frame progress")
    p.add_argument("--compiled", action="store_true",
                   help="whole-experiment capture (not ported: CUDA-graph capture, ROADMAP.md)")
    p.add_argument("--resume", action="store_true",
                   help="reuse the newest sweep JSONL: skip finished grid points")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="K",
                   help="persist per-point training state every K frames (the runners defer "
                        "checkpointing: ROADMAP.md, queue 1: 'Checkpoint/resume')")
    return p


def sweep_resume_kwargs(args) -> dict:
    """run_sweep kwargs for the shared --resume / --checkpoint-every flags."""
    return {"skip_done": args.resume, "checkpoint_every": args.checkpoint_every}


def make_progress(verbose: bool):
    if not verbose:
        return None

    def progress(step, m):
        fields = ", ".join(
            f"{k}={np.round(np.asarray(v), 5)}" for k, v in m.items()
            if k in ("loss", "ser", "ser_soft", "ser_const", "mi", "snr_est_db"))
        print(f"  step {step}: {fields}", flush=True)

    return progress


def setup(args):
    """(device, seed) of a driver run; the card unless ``--device cpu``."""
    return resolve_device(args.device), args.seed


def save_results(out_dir, tag, save_dict):
    name = f"{out_dir}/SERvsSNR_{tag}_{time.strftime('%y%m%d%H%M%S')}.mat"
    io.save_mat(name, save_dict)
    print("saved", name)
    return name
