"""A check of kernels I and J on the card: their ptxas figures and phase
clocks, this tree against a parent checkout, and (``--phases``)
chip_smoke.py's phases 25-29 alone.

Builds every kernel library and prints the ptxas figures (registers, stack,
spills) of every entry of kernels I and J. At chip_smoke.py's phase 25 shapes
for I (``AwgnCmaConfig()``: R = 8, 2 epochs of 4,000 symbols at sps 2, M = 25,
epe 1, the phase's seeds) and phase 27's for J (the DFE sweep's 40 chains of
128,000 symbols, 64 points, K2 = 4, seed 97): each kernel's clock64() cycles
per phase (``cma_siso_clocks``, ``dfe_clocks``; run 0 / chain 0), whether two
launches give the same bits, I held to its plain version at phase 25's
tolerances (rtol 1e-4 over 1e-6 of each tensor's scale) and J's decisions to
its plain version bit for bit (``--skip-plain`` leaves out J's plain loop,
~20-30 s on the card).

With ``--parent DIR``, a checkout of the previous commit (``git archive``
unpacked under ``build/``), it imports that checkout's port under another
name, so its kernels run through its own wrappers and signatures, holds this
tree's J to it bit for bit and I at phase 25's tolerances, checks that
kernels C and D (which share I's sources) give the parent's bits, then times the two
in turns (parent, this tree, this tree, parent; CUDA events, the median of
``--reps`` calls in each turn): I's 2-epoch slice and whole 500-epoch
experiment and J's 40 chains, each as the whole wrapper call and as the
launch alone (``chip_smoke._launch_alone_ms``), and the cycles a symbol that
each launch-alone time gives at the card's SM clock. ``--variant NAME=DIR``
(repeatable) adds a copy of this tree's package with one design change under
``DIR``: its clocks and errors are printed, and it joins the turns. A
tolerance missed is reported at once and raised after the timings. Run from
the repository root on a machine with a card:

    python tools/first_check_ij.py [--parent DIR] [--variant NAME=DIR ...] [--reps N] [--phases]
"""

from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import re
import subprocess
import sys
import time
import types

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from first_check_e import import_port as _import_e  # noqa: E402
from vae_equalizer_tpu_torch.models import dirac_taps_dp, dirac_taps_siso  # noqa: E402
from vae_equalizer_tpu_torch.ops import _build  # noqa: E402
from vae_equalizer_tpu_torch.ops import cma_frame_kernel as dk  # noqa: E402
from vae_equalizer_tpu_torch.ops import cma_kernel as ck  # noqa: E402
from vae_equalizer_tpu_torch.ops import cma_siso_kernel as ik  # noqa: E402
from vae_equalizer_tpu_torch.ops import dfe_kernel as jk  # noqa: E402
from vae_equalizer_tpu_torch.train import awgn as train_awgn  # noqa: E402
from vae_equalizer_tpu_torch.train import dfe as train_dfe  # noqa: E402
from vae_equalizer_tpu_torch.utils import AwgnCmaConfig, LmmseDfeConfig  # noqa: E402


def import_port(checkout: pathlib.Path, name: str) -> types.SimpleNamespace:
    """Kernels I and J's wrappers of another checkout's port, imported under the
    package name ``name``; its kernels build into that checkout's build/kernels/."""
    port = _import_e(checkout, name)
    return types.SimpleNamespace(i=sys.modules[f"{name}.ops.cma_siso_kernel"],
                                 j=sys.modules[f"{name}.ops.dfe_kernel"],
                                 c=importlib.import_module(f"{name}.ops.cma_kernel"),
                                 d=importlib.import_module(f"{name}.ops.cma_frame_kernel"), build=port.build)


def same_c_d(new, parent, dev) -> dict:
    """Kernels C and D (which share I's sources) against the parent's, bit for
    bit: C with and without the update, D as CMAbatch and CMAflex, on 5 runs
    of a 10,000-symbol frame at sps 2, M = 25 (unit normal samples x 0.7)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rx = 0.7 * torch.randn((5, 2, 2, 20000), generator=gen, device=dev)
    h0 = (dirac_taps_dp(25, dev) + 0.01 * torch.randn((5, 2, 2, 2, 25), generator=gen, device=dev)).contiguous()
    out = {}
    for name, call in (("C update", lambda p: p.c.cma_dp_kernel(rx, 1.0, h0, 1e-4, 2, True)),
                       ("C frozen", lambda p: p.c.cma_dp_kernel(rx, 1.0, h0, 1e-4, 2, False)),
                       ("D CMAbatch", lambda p: p.d.cma_chunked_frame(rx, 1.0, h0, 1e-4, 100, 100, 2)),
                       ("D CMAflex", lambda p: p.d.cma_chunked_frame(rx, 1.0, h0, 1e-5, 100, 10, 2))):
        out[name] = all(torch.equal(a, b) for a, b in zip(call(new), call(parent)))
    return out


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]


def ptxas_lines(log: str) -> list:
    """Registers, stack and spills of every entry of kernels I and J."""
    out, entry = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = m.group(1) if ("cma_siso" in m.group(1) or "dfe_decide" in m.group(1)) else None
        elif entry and ("stack frame" in ln or "registers" in ln):
            out.append(f"{entry}: {ln.split(':', 1)[-1].strip()}")
    return out


def setup(dev) -> dict:
    """Phase 25's I arguments (a 2-epoch slice), the whole experiment's, and
    phase 27's J arguments."""
    cfg = AwgnCmaConfig()
    _, sims, _, _, _ = train_awgn._setup(cfg, dev)
    R, M = chip_smoke.CMA_AWGN_RUNS, cfg.m_est
    gen = torch.Generator(device=dev)
    gen.manual_seed(2468)
    rng = torch.Generator(device=dev)
    rng.manual_seed(13)
    draws = lambda kind, index, runs: sims[kind].draws(gen, runs)  # noqa: E731
    h0 = dirac_taps_siso(M, dev) + 0.01 * torch.randn((R, 2, M), generator=rng, device=dev)
    rx2 = train_awgn._frame_train_data(sims["train"], draws, R, chip_smoke.CMA_AWGN_CHECK_EPOCHS)
    rx_all = train_awgn._frame_train_data(sims["train"], draws, R, cfg.num_epochs)
    dcfg = LmmseDfeConfig()
    n = dcfg.n_valid
    c = train_dfe._dfe_chains(dcfg, 97, dev)
    k2 = c["fb"].shape[-1]
    nc = c["ff_out"].shape[0] * c["ff_out"].shape[1]
    j_args = (c["ff_out"].reshape(nc, 2, n).contiguous(),
              c["fb"].expand(-1, dcfg.num_epochs, -1, -1).reshape(nc, 2, k2).contiguous(),
              c["points"].contiguous(), c["init_idx"].reshape(nc, n).contiguous())
    return {"i": (rx2, h0, cfg.R, cfg.lr, cfg.sps, 1),
            "i_whole": (rx_all, h0, cfg.R, cfg.lr, cfg.sps, cfg.epe),
            "i_steps": chip_smoke.CMA_AWGN_CHECK_EPOCHS * cfg.n_train,
            "i_whole_steps": cfg.num_epochs * cfg.n_train,
            "j": j_args, "j_steps": n - k2}


def hold_i(got, want, errs: dict) -> None:
    """Phase 25's tolerances."""
    for name, g_, w_ in zip(("h", "h_ev", "loss"), got, want):
        chip_smoke._check(name, g_, w_, 1e-4, 1e-6 * float(w_.abs().max()), errs)


def check_port(port, st: dict, name: str, missed: list, plain_j: bool) -> dict:
    """Clocks per phase (where the port has them), two launches bit for bit,
    and I / J against their plain versions; printed and returned."""
    rec = {}
    one, two = port.i.cma_siso_experiment(*st["i"]), port.i.cma_siso_experiment(*st["i"])
    rec["i_bit_identical"] = all(torch.equal(u, v) for u, v in zip(one, two))
    rec["i_clocks"] = port.i.cma_siso_clocks(*st["i"])
    errs: dict = {}
    try:
        hold_i(one, ik.cma_siso_experiment_plain(*st["i"]), errs)
    except AssertionError as e:
        missed.append(f"{name} I vs plain: {e}")
        print(missed[-1], flush=True)
    rec["i_errs_vs_plain"] = errs
    chip_smoke._line(f"{name} I", bit_identical=rec["i_bit_identical"], errs=chip_smoke._fmt(errs),
                     **chip_smoke._clocks_kv(rec["i_clocks"]))
    if not rec["i_bit_identical"]:
        missed.append(f"{name} I: two launches differ")
    one, two = port.j.dfe_decide(*st["j"]), port.j.dfe_decide(*st["j"])
    rec["j_bit_identical"] = bool(torch.equal(one, two))
    if not rec["j_bit_identical"]:
        missed.append(f"{name} J: two launches differ")
    if hasattr(port.j, "dfe_clocks"):
        rec["j_clocks"] = port.j.dfe_clocks(*st["j"])
    if hasattr(port.j, "dfe_route"):
        rec["j_route"] = port.j.dfe_route(st["j"][2])
    if plain_j:
        want = jk.dfe_decide_plain(*st["j"])
        rec["j_equal_plain"] = bool(torch.equal(one, want))
        if not rec["j_equal_plain"]:
            missed.append(f"{name} J: {int((one != want).sum())} decisions differ from plain")
    chip_smoke._line(f"{name} J", bit_identical=rec["j_bit_identical"], route=rec.get("j_route"),
                     equal_plain=rec.get("j_equal_plain"),
                     **(chip_smoke._clocks_kv(rec["j_clocks"]) if "j_clocks" in rec else {}))
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--skip-plain", action="store_true", help="leave out J's plain loop")
    ap.add_argument("--phases", action="store_true", help="also run chip_smoke.py's phases 25-29")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("first_check_ij: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _smi("name,power.limit")
    sm_mhz = float(_smi("clocks.max.sm").split()[0])
    print(card, f"max SM clock {sm_mhz:.0f} MHz", torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    _, secs, log = _build.build()
    print(f"build {secs:.1f} s; ptxas:", flush=True)
    for ln in ptxas_lines(log):
        print("  " + ln, flush=True)
    dev = torch.device("cuda")
    st = setup(dev)
    new = types.SimpleNamespace(i=ik, j=jk, c=ck, d=dk, build=_build)
    parent = import_port(args.parent, "parent_port") if args.parent is not None else None
    variants = {}
    for spec in args.variant:
        v_name, v_dir = spec.split("=", 1)
        variants[v_name] = import_port(pathlib.Path(v_dir), f"variant_{len(variants)}")
    report, missed = {"card": card, "sm_mhz_max": sm_mhz}, []
    ports = {**({"parent": parent} if parent is not None else {}), "new": new, **variants}
    for name, port in ports.items():
        if port is not new:
            for ln in ptxas_lines(port.build.build()[2]):
                print(f"  {name}: {ln}", flush=True)
        report[name] = check_port(port, st, name, missed,
                                  plain_j=not args.skip_plain and port is new)
    if parent is not None:
        got, want = ik.cma_siso_experiment(*st["i"]), parent.i.cma_siso_experiment(*st["i"])
        errs: dict = {}
        try:
            hold_i(got, want, errs)
        except AssertionError as e:
            missed.append(f"new I vs parent: {e}")
        same_i = all(torch.equal(u, v) for u, v in zip(got, want))
        same_j = bool(torch.equal(jk.dfe_decide(*st["j"]), parent.j.dfe_decide(*st["j"])))
        if not same_j:
            missed.append("new J vs parent: decisions differ")
        same_cd = same_c_d(new, parent, dev)
        missed += [f"new {k} differs from the parent's" for k, v in same_cd.items() if not v]
        report["vs_parent"] = {"i_bit_identical": same_i, "i_errs": errs, "j_bit_identical": same_j,
                               "c_d_bit_identical": same_cd}
        chip_smoke._line("new vs parent", i_bit_identical=same_i, i_errs=chip_smoke._fmt(errs),
                         j_bit_identical=same_j, c_d_bit_identical=same_cd)
    order = list(ports) + list(ports)[::-1]
    report["turns_ms"] = {}
    for what, key, launcher, steps in (
            ("I slice", "i", "cma_siso_experiment_launch", st["i_steps"]),
            ("I whole", "i_whole", "cma_siso_experiment_launch", st["i_whole_steps"]),
            ("J", "j", "dfe_decide_launch", st["j_steps"])):
        t = {who: {"call": [], "launch": []} for who in ports}
        reps = max(1, args.reps // 2) if key == "i_whole" else args.reps
        for who in order:
            fn = ports[who].i.cma_siso_experiment if key.startswith("i") else ports[who].j.dfe_decide
            call = lambda fn=fn: fn(*st[key])  # noqa: E731
            t[who]["call"].append(chip_smoke._time_ms(call, reps=reps))
            t[who]["launch"].append(chip_smoke._launch_alone_ms(call, launcher, reps, ports[who].build))
        for tt in t.values():
            tt["cycles_per_symbol"] = [1e-3 * ms * sm_mhz * 1e6 / steps for ms in tt["launch"]]
        report["turns_ms"][what] = t
        print(f"turns {what} (order {','.join(order)}): " + "; ".join(
            f"{who} " + " / ".join(f"{v:.4f}" for v in tt["call"]) + " ms, launch alone "
            + " / ".join(f"{v:.4f}" for v in tt["launch"]) + " ms ("
            + " / ".join(f"{v:.0f}" for v in tt["cycles_per_symbol"]) + " cycles a symbol at max clock)"
            for who, tt in t.items()), flush=True)
    if args.phases:
        entries = chip_smoke._cma_awgn_phases(card) + chip_smoke._dfe_phases(card)
        chip_smoke._drivers_phase(card)
        print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps(report), flush=True)
    print(f"{card} total_s={time.perf_counter() - t0:.1f}", flush=True)
    if missed:
        raise SystemExit("; ".join(missed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
