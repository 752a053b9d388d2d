"""A short check of kernel H on the card, before chip_smoke.py: its phase
clocks, and this tree against a parent checkout.

Builds every kernel library and prints the nn library's ptxas lines
(registers, spills, shared memory). At the full VAE-NN width
(``AwgnVaeNnConfig()``: 64-QAM, C = 16, k1 = 25, bl 300, 13 steps per epoch,
R = 8, chip_smoke.py's perturbed start and channel draws), for Net and
Net_BN: kernel H's phase clocks (run 0's block, clock64() cycles per step
and each phase's share) over phase 13b's 20-epoch slice, and whether two
launches on the same inputs give the same bits. With ``--parent DIR``, a
checkout of the previous commit (``git archive`` unpacked under ``build/``),
it imports that checkout's port under another name, so its kernel runs
through its own wrapper and signature, and holds this tree's H to it: 2
epochs from the perturbed start at phase 13a's tolerances (losses rtol 1e-4;
parameters, running statistics and eval slots rtol 1e-3 over 1e-5), and 10
epochs from a 20-epoch warm state at phase 13b's (losses rtol 1e-3). Then
it times the two in turns (parent, this tree, this tree, parent; CUDA
events, the median of each turn) on the 20-epoch slice and, with
``--whole``, on the whole 500-epoch experiment. A tolerance missed against
the parent is reported at once and raised after the timings. Run from the
repository root on a machine with a card: ``python tools/first_check_h.py
[--parent DIR] [--whole]``.
"""

import argparse
import importlib
import importlib.util
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from vae_equalizer_tpu_torch.models.vae_nn import vae_nn_init  # noqa: E402
from vae_equalizer_tpu_torch.ops import _build  # noqa: E402
from vae_equalizer_tpu_torch.ops import nn_frame_kernel as nfk  # noqa: E402
from vae_equalizer_tpu_torch.train import awgn as train_awgn  # noqa: E402
from vae_equalizer_tpu_torch.utils import AwgnVaeNnConfig  # noqa: E402

NAMES = ("w1f", "w2f", "h", "bnp", "rs")
SLOTS = ((7, "w1_ev"), (8, "w2_ev"), (9, "h_ev"), (10, "bnp_ev"), (11, "rs_ev"))


def import_nn_kernel(checkout: pathlib.Path, name: str = "parent_port"):
    """``ops/nn_frame_kernel`` of another checkout's port, imported under the
    package name ``name`` (its modules import each other relatively, so they
    stay within it); its kernels build into that checkout's build/kernels/."""
    pkg = checkout.resolve() / "vae_equalizer_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops.nn_frame_kernel")


def setup(bn_on: bool, dev, R: int = chip_smoke.NN_RUNS) -> dict:
    """chip_smoke phase 13's start (perturbed init, seed 5) and channel rows."""
    cfg = AwgnVaeNnConfig(batchnorm=bn_on)
    const, sims, amps, _, _ = train_awgn._setup(cfg, dev, fixed_noise=True)
    k1, n_lev, M = cfg.kernel_1, const.num_lev, cfg.m_est
    ch = 2 * n_lev
    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    draws = lambda kind, index, runs: sims[kind].draws(gen, runs)
    g0 = torch.Generator()
    g0.manual_seed(5)
    net, _ = vae_nn_init(g0, k1, cfg.kernel_2, n_lev, bn_on)
    pert = lambda t: (t + 0.01 * torch.randn((R,) + t.shape, generator=g0)).contiguous().to(dev)
    w1f, w2f = (pert(t) for t in nfk.flatten_nn_params(net))
    h0 = torch.zeros((2, M))
    h0[0, M // 2] = 1.0
    h0 = pert(h0)
    bn = None
    if bn_on:
        bn = (torch.stack([torch.ones(R, ch), torch.zeros(R, ch)], -1).to(dev),
              torch.stack([torch.zeros(R, ch), torch.ones(R, ch)], -1).to(dev))
    opt0 = nfk.nn_frame_opt_init(w1f, w2f, h0, None if bn is None else bn[0])
    return dict(cfg=cfg, amps=amps, start=(w1f, w2f, h0, opt0), bn=bn,
                rx=lambda n: train_awgn._frame_train_data(sims["train"], draws, R, n),
                kw=dict(bl_sym=cfg.batch_len, n_batches=cfg.n_train // cfg.batch_len, epe=cfg.epe,
                        k1=k1))


def args_of(st: dict, rx) -> tuple:
    return (*st["start"], rx, st["amps"], st["cfg"].lr, st["bn"], 0.1)


def check_parent(pnk, st: dict, bn_on: bool) -> dict:
    """This tree's H against the parent's at phases 13a / 13b's tolerances;
    raises AssertionError on a miss. Returns the errors."""
    kw, errs = st["kw"], {}
    a_args = args_of(st, st["rx"](2))
    got, want = nfk.vae_nn_experiment_train(*a_args, **kw), pnk.vae_nn_experiment_train(*a_args, **kw)
    torch.cuda.synchronize()
    chip_smoke._check("13a losses", got[6], want[6], 1e-4, 0.0, errs)
    for i, name in (*enumerate(NAMES), *SLOTS):
        if bn_on or name[:2] not in ("bn", "rs"):
            chip_smoke._check(f"13a {name}", got[i], want[i], 1e-3, 1e-5, errs)
    warm = pnk.vae_nn_experiment_train(*a_args[:4], st["rx"](20), *a_args[5:], **kw)
    b_args = (*warm[:3], warm[5], st["rx"](10), st["amps"], st["cfg"].lr,
              (warm[3], warm[4]) if bn_on else None, 0.1)
    step0 = 20 * kw["n_batches"]
    got = nfk.vae_nn_experiment_train(*b_args, **kw, step0=step0)
    want = pnk.vae_nn_experiment_train(*b_args, **kw, step0=step0)
    torch.cuda.synchronize()
    chip_smoke._check("13b losses", got[6], want[6], 1e-3, 0.0, errs)
    for i, name in enumerate(NAMES[:3]):
        d = (got[i] - want[i]).abs().max().item()
        errs[f"13b {name}"] = (d, d / want[i].abs().max().item())
    return errs


def turns(fns: dict, reps: int) -> dict:
    """CUDA-event median of each fn over ``reps`` runs, in the turns parent,
    new, new, parent; {name: [turn 1, turn 2]}."""
    out = {k: [] for k in fns}
    for k in ("parent", "new", "new", "parent"):
        out[k].append(chip_smoke._time_ms(fns[k], reps=reps))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    ap.add_argument("--whole", action="store_true", help="also time the whole 500-epoch experiment")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, secs, log = _build.build()
    lines = log.splitlines()
    nn_lines = [ln.strip() for i, ln in enumerate(lines) if "vae_nn" in ln
                or (i > 0 and "vae_nn" in lines[i - 1]) or (i > 1 and "vae_nn" in lines[i - 2])]
    print(f"build {secs:.1f} s; nn ptxas:", " | ".join(nn_lines)[:2000], flush=True)
    dev = torch.device("cuda")
    pnk = import_nn_kernel(args.parent) if args.parent is not None else None
    report, missed = {"card": card}, []
    for bn_on in (False, True):
        variant = "Net_BN" if bn_on else "Net"
        st = setup(bn_on, dev)
        kw = st["kw"]
        t_args = args_of(st, st["rx"](chip_smoke.NN_TIMED_EPOCHS))
        clocks = nfk.nn_clocks(*t_args, **kw)
        one, two = nfk.vae_nn_experiment_train(*t_args, **kw), nfk.vae_nn_experiment_train(*t_args, **kw)
        same = all(torch.equal(u, v) for x, y in zip(one, two)
                   for u, v in (zip(x.values(), y.values()) if isinstance(x, dict) else ((x, y),)))
        chip_smoke._line(f"clocks H {variant} {chip_smoke.NN_TIMED_EPOCHS} epochs", bit_identical=same,
                         **chip_smoke._clocks_kv(clocks))
        rep = {"clocks_per_step": clocks, "bit_identical": same}
        if not same:
            missed.append(f"{variant}: two launches differ")
        if pnk is not None:
            try:
                errs = check_parent(pnk, st, bn_on)
                print(f"parent {variant}: within phases 13a / 13b: {chip_smoke._fmt(errs)}", flush=True)
            except AssertionError as e:
                missed.append(f"parent {variant}: {e}")
                print(missed[-1], flush=True)
            cases = {"slice": (t_args, 3)}
            if args.whole:
                cases["whole"] = (args_of(st, st["rx"](st["cfg"].num_epochs)), 1)
            rep["turns_ms"] = {}
            for case, (c_args, reps) in cases.items():
                t = turns({"parent": lambda c_args=c_args: pnk.vae_nn_experiment_train(*c_args, **kw),
                           "new": lambda c_args=c_args: nfk.vae_nn_experiment_train(*c_args, **kw)},
                          reps)
                rep["turns_ms"][case] = t
                print(f"turns H {variant} {case}: parent {t['parent'][0]:.4f} / {t['parent'][1]:.4f} ms, "
                      f"new {t['new'][0]:.4f} / {t['new'][1]:.4f} ms, speed-up "
                      f"{min(t['parent']) / max(t['new']):.2f}-{max(t['parent']) / min(t['new']):.2f}x",
                      flush=True)
        report[variant] = rep
    print(json.dumps(report), flush=True)
    if missed:
        raise SystemExit("; ".join(missed))


if __name__ == "__main__":
    main()
