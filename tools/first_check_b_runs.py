"""A short check of kernels A and B on the card, before chip_smoke.py: their
instances' ptxas figures, their phase clocks, their run constants, and this
tree against a parent checkout.

Builds every kernel library and prints, for each instance of A and B
(``csrc/dp_kernels.cu``: 8 levels or generic, float32 or bfloat16 streams),
its registers, stack and spills. Prints kernel B's phase clocks (run 0's
block, clock64() cycles per step and each phase's share) at B's four shapes
of the main path: the flagship's 100-step frame and VAEflex's 990-window
frame (stride_sym 10) at R = 8, from a state warmed by 20 frames; R = 40
with per-run var / lr (the SNR sweep's runs); the streaming receiver's
R = 1 20-step frame. Then a 3-frame flagship experiment (CUDA-graph replay):
B's launches. With ``--parent DIR``, a
checkout of the previous commit (e.g. ``git archive`` unpacked under
``build/``), it imports that checkout's port under another name, so its
kernels run through its own wrappers and signatures, and holds this tree's
kernels to it: A on one minibatch and B over 3 minibatches across the lr
halving at phases 3 and 4a's tolerances; then A, and B at the four shapes
and through the generic instance at 4-QAM (bl 16, M 9) and 256-QAM (16
levels), bit for bit on every output (w, h, the four moments, losses,
var_est, out, dec, eq, mm, s1). It prints both trees' clocks side by side
and times the two in turns (parent, this tree, this tree, parent; CUDA
events, the median of each turn) at the six shapes of B and on A. Last,
chip_smoke's phase 21 (kernel B's per-run lr / var / nu_sc / P against its
plain version, constant vectors and rows against the shared form bit for
bit, stream_bf16 against float32). A check missed against the parent is
reported at once and raised after the timings. Run from the repository root
on a machine with a card: ``python tools/first_check_b_runs.py [--parent
DIR]``.
"""

import argparse
import dataclasses
import importlib
import importlib.util
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from vae_equalizer_tpu_torch.core import make_constellation  # noqa: E402
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


def ptxas_summary(log: str, part: str) -> list:
    """Each compiled kernel whose mangled name holds ``part``: (its name and
    template arguments, registers, stack bytes, spill store and load bytes)."""
    rows, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = m.group(1) if part in m.group(1) else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            stack = tuple(int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            rows.append((_demangle(name, part), int(m.group(1)), *stack))
            name = None
    return rows


def _demangle(name: str, part: str) -> str:
    """A kernel's mangled name as ``kernel<arg, ...>`` (bool and int template arguments)."""
    m = re.search(f"({part}\\w*?_kernel)((?:L[bi]\\d+E)*)", name.replace("IL", "L", 1))
    if not m:
        return name
    args = [{"b0": "false", "b1": "true"}.get(a, a[1:]) for a in re.findall(r"L([bi]\d+)E", m.group(2))]
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def turns(fns: dict, reps: int) -> dict:
    """CUDA-event median of each fn over ``reps`` runs, in the turns parent,
    new, new, parent; {name: [turn 1, turn 2]}."""
    out = {k: [] for k in fns}
    for k in ("parent", "new", "new", "parent"):
        out[k].append(chip_smoke._time_ms(fns[k], reps=reps))
    return out


def flat(res) -> dict:
    """Kernel B's return as {output: tensor}, the moments spread out."""
    names = ("w", "h", "opt", "losses", "var_est", "out", "dec", "eq", "mm", "s1")
    return {**{k: v for k, v in zip(names, res) if k != "opt"}, **res[2]}


def b_shapes(cfg, dev, gen, f_args) -> dict:
    """Kernel B's calls: {shape: (arguments, keywords, reps when timed)} at the
    four shapes of the main path (``f_args``: the warm flagship frame) and two
    of the generic instance."""
    wk, hk, optk, rx_f, amps, var, nu_sc, P, lr, step0, thresh = f_args
    bl, R = cfg.batch_len, wk.shape[0]
    # R = 40: the warm state five times over, each run with its own SNR's var and its lr
    R40 = 5 * R
    rep = lambda t: t.repeat((5,) + (1,) * (t.dim() - 1)).contiguous()
    snrs = np.repeat(np.arange(16.0, 24.0), 5)
    const = make_constellation(cfg.mod, 0.0)
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    r40 = (rep(wk), rep(hk), {k: rep(v) for k, v in optk.items()}, rep(rx_f), amps,
           T([[const.pow_mean / 10 ** (s / 10) / 2] * 2 for s in snrs]), nu_sc, P,
           T(np.linspace(1e-3, 3.5e-3, R40)), step0, thresh)
    # the streaming receiver's block: 20 minibatches of run 0, no lr halving
    s1 = (wk[:1].contiguous(), hk[:1].contiguous(), {k: v[:1].contiguous() for k, v in optk.items()},
          rx_f[:1, ..., : 2 * 20 * bl].contiguous(), amps, var, nu_sc, P, lr, step0, float("inf"))
    shapes = {"100-step R=8": (f_args, {"bl_sym": bl}, 5),
              "990-window R=8": (f_args, {"bl_sym": bl, "stride_sym": cfg.flex_step}, 3),
              "R=40 per-run var/lr": (r40, {"bl_sym": bl}, 5),
              "stream R=1 20-step": (s1, {"bl_sym": bl}, 10)}
    for mod, blm, mm in (("4-QAM", 16, 9), ("256-QAM", 100, 25)):
        c = DpConfig(mod=mod, batch_len=blm, m_est=mm)
        const_m, var_m, sim_m, amps_m, P_m = train_dp._setup(c, 100 * blm, dev)
        w = butterfly_init(mm, dev).expand(R, 2, 4, mm).contiguous()
        h = dirac_taps_dp(mm, dev).expand(R, 2, 2, 2, mm).contiguous()
        shapes[f"generic {mod} bl{blm} R=8"] = (
            (w, h, frame_kernel.frame_opt_init({"w": w, "h": h}), sim_m(gen, float(c.theta), R)[0],
             amps_m, var_m, const_m.nu_sc, P_m, c.lr, 0, float("inf")), {"bl_sym": blm}, 5)
    return shapes


def compare_parent(parent: pathlib.Path, shapes: dict, b3_args, a_args, bl: int) -> tuple:
    """This tree's kernels A and B against the parent checkout's, then timed
    in turns. Returns ({case: {"parent": [ms, ms], "new": [ms, ms]}}, the
    parent's clocks {shape: {phase: cycles}}, the check missed or None)."""
    pek, pfk = import_port(parent)
    try:
        check_parent(pek, pfk, shapes, b3_args, a_args, bl)
        missed = None
    except AssertionError as e:
        missed = f"parent {parent}: {e}"
        print(missed, flush=True)
    parent_clocks = {k: pfk.frame_clocks(*args, **kw) for k, (args, kw, _) in shapes.items()}
    cases = {f"B {k}": ({"parent": lambda a=args, kw=kw: pfk.vae_dp_frame_train(*a, **kw),
                         "new": lambda a=args, kw=kw: frame_kernel.vae_dp_frame_train(*a, **kw)}, reps)
             for k, (args, kw, reps) in shapes.items()}
    cases["A R=8"] = ({"parent": lambda: pek.vae_dp_loss_and_grad(*a_args),
                       "new": lambda: elbo_kernel.vae_dp_loss_and_grad(*a_args)}, 20)
    times = {}
    for case, (fns, reps) in cases.items():
        times[case] = turns(fns, reps)
        t = times[case]
        print(f"turns {case}: parent {t['parent'][0]:.4f} / {t['parent'][1]:.4f} ms, new "
              f"{t['new'][0]:.4f} / {t['new'][1]:.4f} ms, speed-up "
              f"{min(t['parent']) / max(t['new']):.3f}-{max(t['parent']) / min(t['new']):.3f}x",
              flush=True)
    return times, parent_clocks, missed


def check_parent(pek, pfk, shapes: dict, b3_args, a_args, bl: int) -> None:
    """Kernels A and B of this tree against the parent's modules: phases 3
    and 4a's tolerances, then every output bit for bit (A; B at each of
    ``shapes``); raises AssertionError on a miss."""
    amps, var, nu_sc = b3_args[4], b3_args[5], b3_args[6]
    # phase 3: kernel A, one minibatch of R runs read in place
    got = elbo_kernel.vae_dp_loss_and_grad(*a_args)
    want = pek.vae_dp_loss_and_grad(*a_args)
    torch.cuda.synchronize()
    errs: dict = {}
    for name, g, w in zip(("loss", "var_est", "gw", "gh", "q", "out"), got, want):
        chip_smoke._check(f"A {name}", g, w, 1e-4, 1e-4 * float(w.abs().max()), errs)
    differ = [f"A {name}" for name, g, w in zip(("loss", "var_est", "gw", "gh", "q", "out"), got, want)
              if not torch.equal(g, w)]
    # phase 4a: kernel B, 3 minibatches across the lr halving
    got = frame_kernel.vae_dp_frame_train(*b3_args, bl_sym=bl)
    want = pfk.vae_dp_frame_train(*b3_args, bl_sym=bl)
    torch.cuda.synchronize()
    dec_mis = chip_smoke._check_b3(got, want, amps, var, nu_sc, 1e-6, errs)
    print(f"parent: A and B within phases 3 / 4a: {chip_smoke._fmt(errs)} dec_tie_mismatch={dec_mis}",
          flush=True)
    for shape, (args, kw, _) in [("4a 3-step R=8", (b3_args, {"bl_sym": bl}, 0)), *shapes.items()]:
        got = flat(frame_kernel.vae_dp_frame_train(*args, **kw))
        want = flat(pfk.vae_dp_frame_train(*args, **kw))
        torch.cuda.synchronize()
        bad = [k for k in want if not torch.equal(got[k], want[k])]
        print(f"parent: B {shape} bit for bit: {'yes' if not bad else 'no, ' + ','.join(bad)}", flush=True)
        differ += [f"B {shape} {k}" for k in bad]
    if differ:
        raise AssertionError(f"not bit for bit with the parent: {differ}")
    print("parent: A and B bit for bit at every shape", flush=True)


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
    print(f"build {secs:.1f} s", flush=True)
    for row in ptxas_summary(log, "vae_dp_"):
        print("ptxas {}: {} registers, {} bytes stack, {} / {} bytes spill stores / loads".format(*row),
              flush=True)
    dev = torch.device("cuda")
    cfg = DpConfig()
    m_max = cfg.n_frame_max // cfg.batch_len
    const, var, sim, amps, P = train_dp._setup(cfg, m_max * cfg.batch_len, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    R, M, bl = 8, cfg.m_est, cfg.batch_len
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
    shapes = b_shapes(cfg, dev, gen, f_args)
    clocks = {k: frame_kernel.frame_clocks(*a, **kw) for k, (a, kw, _) in shapes.items()}
    for label, c in clocks.items():
        chip_smoke._line(f"clocks {label}", **chip_smoke._clocks_kv(c))
    frame_kernel.vae_dp_frame_train.launches = 0
    train_dp.train_vae_dp(dataclasses.replace(cfg, num_frames=3), seed=0, device=dev, use_pallas="frame",
                          runs=R, compiled=True)
    launches = frame_kernel.vae_dp_frame_train.launches
    print(f"flagship 3-frame replay: B launches {launches}", flush=True)
    times, parent_clocks, missed = None, None, None
    if args.parent is not None:
        b3_args = (w0, h0, frame_kernel.frame_opt_init({"w": w0, "h": h0}),
                   rx_f[..., : 3 * 2 * bl].contiguous(), amps, var, const.nu_sc, P, cfg.lr, 40, 41.0)
        a_args = (w0, h0, rx_f[..., 2 * bl : 4 * bl], amps, var, const.nu_sc, P)
        times, parent_clocks, missed = compare_parent(args.parent, shapes, b3_args, a_args, bl)
        for k in shapes:
            print(f"clocks {k} (cycles a step, parent -> this tree): " + ", ".join(
                f"{ph} {parent_clocks[k][ph]:.0f} -> {clocks[k][ph]:.0f}" for ph in clocks[k])
                + f"; total {sum(parent_clocks[k].values()):.0f} -> {sum(clocks[k].values()):.0f}",
                flush=True)
    print(json.dumps({"card": card, "clocks_per_step": clocks, "parent_clocks_per_step": parent_clocks,
                      "turns_ms": times, "flagship_launches": launches}),
          flush=True)
    t0 = time.perf_counter()
    res = chip_smoke._per_run_phase(card, cfg, sim, gen, w0, h0, const, amps, P, f_args)
    print(f"phase 21: {time.perf_counter() - t0:.1f} s, {res}", flush=True)
    if missed:
        raise SystemExit(missed)


if __name__ == "__main__":
    main()
