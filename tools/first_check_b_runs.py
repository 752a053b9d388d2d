"""A short check of kernels A and B on the card, before chip_smoke.py: their
phase clocks, their run constants, and this tree against a parent checkout.

Builds every kernel library and prints the dp library's ptxas lines; prints
kernel B's phase clocks (run 0's block, clock64() cycles per step and each
phase's share) on the flagship's 100-step frame and VAEflex's 990-window
frame (stride_sym 10) at R = 8, from a state warmed by 20 frames. With
``--parent DIR``, a checkout of the previous commit (e.g. ``git
archive`` unpacked under ``build/``), it imports that checkout's port under
another name, so its kernels run through its own wrappers and signatures,
and holds this tree's kernels to it: A on one minibatch at phase 3's
tolerances, B over 3 minibatches across the lr halving at phase 4a's, B
over the warm 100-step frame at phase 4b's and over the first 100 windows of
the 990-window frame at phase 18b's. Then it times the two in turns (parent,
this tree, this tree, parent; CUDA events, the median of each turn) on
those three calls. Last, chip_smoke's phase 21 (kernel B's per-run lr / var
/ nu_sc / P against its plain version, constant vectors and rows against the
shared form bit for bit, stream_bf16 against float32). A tolerance missed
against the parent is reported at once and raised after the timings. Run
from the repository root on a machine with a card: ``python
tools/first_check_b_runs.py [--parent DIR]``.
"""

import argparse
import dataclasses
import importlib
import importlib.util
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from vae_equalizer_tpu_torch.models import butterfly_init, dirac_taps_dp  # noqa: E402
from vae_equalizer_tpu_torch.ops import _build, elbo_kernel, frame_kernel  # noqa: E402
from vae_equalizer_tpu_torch.train import dp as train_dp  # noqa: E402
from vae_equalizer_tpu_torch.utils import DpConfig  # noqa: E402


def import_port(checkout: pathlib.Path, name: str = "parent_port"):
    """The port package of another checkout, imported as ``name`` (its
    modules import each other relatively, so they stay within it). Returns
    its (elbo_kernel, frame_kernel) modules; their kernels build into that
    checkout's build/kernels/."""
    pkg = checkout.resolve() / "vae_equalizer_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops.elbo_kernel"), importlib.import_module(f"{name}.ops.frame_kernel")


def turns(fns: dict, reps: int) -> dict:
    """CUDA-event median of each fn over ``reps`` runs, in the turns parent,
    new, new, parent; {name: [turn 1, turn 2]}."""
    out = {k: [] for k in fns}
    for k in ("parent", "new", "new", "parent"):
        out[k].append(chip_smoke._time_ms(fns[k], reps=reps))
    return out


def compare_parent(parent: pathlib.Path, b3_args, f_args, a_args, bl: int, fs: int) -> tuple:
    """This tree's kernels A and B against the parent checkout's, then timed
    in turns. Returns ({case: {"parent": [ms, ms], "new": [ms, ms]}}, the
    tolerance missed or None)."""
    pek, pfk = import_port(parent)
    try:
        check_parent(pek, pfk, b3_args, f_args, a_args, bl, fs)
        missed = None
    except AssertionError as e:
        missed = f"parent {parent}: {e}"
        print(missed, flush=True)
    cases = {
        "B 100-step frame R=8": ({"parent": lambda: pfk.vae_dp_frame_train(*f_args, bl_sym=bl),
                                  "new": lambda: frame_kernel.vae_dp_frame_train(*f_args, bl_sym=bl)}, 5),
        "B 990-window frame R=8": ({"parent": lambda: pfk.vae_dp_frame_train(*f_args, bl_sym=bl,
                                                                             stride_sym=fs),
                                    "new": lambda: frame_kernel.vae_dp_frame_train(*f_args, bl_sym=bl,
                                                                                   stride_sym=fs)}, 3),
        "A R=8": ({"parent": lambda: pek.vae_dp_loss_and_grad(*a_args),
                   "new": lambda: elbo_kernel.vae_dp_loss_and_grad(*a_args)}, 20),
    }
    times = {}
    for case, (fns, reps) in cases.items():
        times[case] = turns(fns, reps)
        t = times[case]
        print(f"turns {case}: parent {t['parent'][0]:.4f} / {t['parent'][1]:.4f} ms, new "
              f"{t['new'][0]:.4f} / {t['new'][1]:.4f} ms, speed-up "
              f"{min(t['parent']) / max(t['new']):.2f}-{max(t['parent']) / min(t['new']):.2f}x",
              flush=True)
    return times, missed


def check_parent(pek, pfk, b3_args, f_args, a_args, bl: int, fs: int) -> None:
    """Kernels A and B of this tree against the parent's modules at phases 3,
    4a, 4b and 18b's tolerances; raises AssertionError on a miss."""
    amps, var, nu_sc = b3_args[4], b3_args[5], b3_args[6]
    # phase 3: kernel A, one minibatch of R runs read in place
    got = elbo_kernel.vae_dp_loss_and_grad(*a_args)
    want = pek.vae_dp_loss_and_grad(*a_args)
    torch.cuda.synchronize()
    errs: dict = {}
    for name, g, w in zip(("loss", "var_est", "gw", "gh", "q", "out"), got, want):
        chip_smoke._check(f"A {name}", g, w, 1e-4, 1e-4 * float(w.abs().max()), errs)
    # phase 4a: kernel B, 3 minibatches across the lr halving
    got = frame_kernel.vae_dp_frame_train(*b3_args, bl_sym=bl)
    want = pfk.vae_dp_frame_train(*b3_args, bl_sym=bl)
    torch.cuda.synchronize()
    dec_mis = chip_smoke._check_b3(got, want, amps, var, nu_sc, 1e-6, errs)
    # phase 4b: the warm 100-step frame
    got = frame_kernel.vae_dp_frame_train(*f_args, bl_sym=bl)
    want = pfk.vae_dp_frame_train(*f_args, bl_sym=bl)
    torch.cuda.synchronize()
    chip_smoke._check("B100 losses", got[3], want[3], 1e-3, 0.0, errs)
    agree = float((got[6] == want[6]).float().mean())
    # phase 18b: the first 100 windows of the 990-window frame
    got = frame_kernel.vae_dp_frame_train(*f_args, bl_sym=bl, stride_sym=fs)
    want = pfk.vae_dp_frame_train(*f_args, bl_sym=bl, stride_sym=fs)
    torch.cuda.synchronize()
    chip_smoke._check("B990 losses_first100", got[3][:100], want[3][:100], 1e-3, 0.0, errs)
    agree100 = float((got[6][:100] == want[6][:100]).float().mean())
    rel_all = float(((got[3] - want[3]).abs() / want[3].abs()).max())
    agree_all = float((got[6] == want[6]).float().mean())
    if agree < 0.999 or agree100 < 0.999:
        raise AssertionError(f"parent: dec agreement 100-step {agree:.5f}, 990-window first 100 "
                             f"{agree100:.5f}")
    print(f"parent: A and B within phases 3 / 4a / 4b / 18b: {chip_smoke._fmt(errs)} "
          f"dec_tie_mismatch={dec_mis} dec_agree_100step={agree:.6f} dec_agree_990_first100="
          f"{agree100:.6f} 990 whole frame: losses rel {rel_all:.3e}, dec agree {agree_all:.6f}",
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, secs, log = _build.build()
    print(f"build {secs:.1f} s;", " | ".join(ln.strip() for ln in log.splitlines()
                                            if "vae_dp" in ln or "registers" in ln)[:3000], flush=True)
    dev = torch.device("cuda")
    cfg = DpConfig()
    m_max = cfg.n_frame_max // cfg.batch_len
    const, var, sim, amps, P = train_dp._setup(cfg, m_max * cfg.batch_len, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    R, M, bl, fs = 8, cfg.m_est, cfg.batch_len, cfg.flex_step
    rng = torch.Generator(device=dev)
    rng.manual_seed(99)
    w0 = butterfly_init(M, dev) + 0.01 * torch.randn((R, 2, 4, M), generator=rng, device=dev)
    h0 = dirac_taps_dp(M, dev) + 0.01 * torch.randn((R, 2, 2, 2, M), generator=rng, device=dev)
    thetas = train_dp._frame_inputs(dataclasses.replace(cfg, num_frames=21), dev)
    wk = butterfly_init(M, dev).expand(R, 2, 4, M).contiguous()
    hk = dirac_taps_dp(M, dev).expand(R, 2, 2, 2, M).contiguous()
    optk, thresh = frame_kernel.frame_opt_init({"w": wk, "h": hk}), float(cfg.n_lrhalf * m_max)
    for f in range(20):
        wk, hk, optk = frame_kernel.vae_dp_frame_train(wk, hk, optk, sim(gen, thetas[f], R)[0], amps, var,
                                                       const.nu_sc, P, cfg.lr, f * m_max, thresh,
                                                       bl_sym=bl)[:3]
    rx_f = sim(gen, thetas[20], R)[0]
    f_args = (wk, hk, optk, rx_f, amps, var, const.nu_sc, P, cfg.lr, 20 * m_max, thresh)
    clocks = {"100-step": frame_kernel.frame_clocks(*f_args, bl_sym=bl),
              "990-window": frame_kernel.frame_clocks(*f_args, bl_sym=bl, stride_sym=fs)}
    for label, c in clocks.items():
        chip_smoke._line(f"clocks {label}", **chip_smoke._clocks_kv(c))
    times, missed = None, None
    if args.parent is not None:
        b3_args = (w0, h0, frame_kernel.frame_opt_init({"w": w0, "h": h0}),
                   rx_f[..., : 3 * 2 * bl].contiguous(), amps, var, const.nu_sc, P, cfg.lr, 40, 41.0)
        a_args = (w0, h0, rx_f[..., 2 * bl : 4 * bl], amps, var, const.nu_sc, P)
        times, missed = compare_parent(args.parent, b3_args, f_args, a_args, bl, fs)
    print(json.dumps({"card": card, "clocks_per_step": clocks, "turns_ms": times}), flush=True)
    t0 = time.perf_counter()
    res = chip_smoke._per_run_phase(card, cfg, sim, gen, w0, h0, const, amps, P, f_args)
    print(f"phase 21: {time.perf_counter() - t0:.1f} s, {res}", flush=True)
    if missed:
        raise SystemExit(missed)


if __name__ == "__main__":
    main()
