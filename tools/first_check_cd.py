"""A short check of kernels C and D on the card, before chip_smoke.py: their
phase clocks, and this tree against a parent checkout.

Builds every kernel library and prints the cma library's ptxas lines
(registers, spills, shared memory). At chip_smoke.py's phase 7 / 8 shapes
(``DpConfig()``: 64-QAM, M = 25, sps 2, one 10,000-symbol frame of the DP
channel, R = 5 runs from a perturbed Dirac start; CMA lr 1e-4, CMAbatch B = S
= 100 at lr 1e-4, CMAflex B = 100, S = 10 at lr 1e-5): kernel C's clock64()
cycles per symbol phase (run 0's lane 0) and kernel D's per chunk phase (run
0's thread 0) for both variants, and whether two launches on the same inputs
give the same bits, and holds both kernels to their plain versions at phase 7
/ 8's tolerances (out, h and e at rtol 1e-4 over 1e-6 of each tensor's
scale). With ``--parent DIR``, a checkout of the previous commit
(``git archive`` unpacked under ``build/``), it imports that checkout's port
under another name, so its kernels run through their own wrappers and
signatures, and holds this tree's C and D to it at the same tolerances. Then it times
the two in turns (parent, this tree, this tree, parent; CUDA events, the
median of each turn), for the whole wrapper call and for the kernel launch
alone (``chip_smoke._launch_alone_ms``: events recorded on the stream right
around the launcher's call). A
tolerance missed against the parent is reported at once and raised after the
timings. With ``--whole`` and a parent, it also times the three 170-frame
CMA experiments (``run_cma_dp(DpConfig(), runs=5)``: CMA on kernel C,
CMAbatch and CMAflex on D, chip_smoke.py's lr) in turns with the parent's,
host clock around each whole run, and prints each run's last-20-frame
constellation SER. ``--variant NAME=DIR`` (repeatable) adds a copy of this tree's
package with a design change (a lever switched off, say) under ``DIR``: its
clocks and its errors against the plain versions are printed, and it joins
the turns (parent, this tree, the variants, then the same in reverse). Run
from the repository root on a machine with a card: ``python
tools/first_check_cd.py [--parent DIR] [--whole] [--variant NAME=DIR ...]
[--reps N]``.
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
import types

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from vae_equalizer_tpu_torch.models import dirac_taps_dp  # noqa: E402
from vae_equalizer_tpu_torch.ops import _build  # noqa: E402
from vae_equalizer_tpu_torch.ops import cma_frame_kernel as cfk  # noqa: E402
from vae_equalizer_tpu_torch.ops import cma_kernel as ck  # noqa: E402
from vae_equalizer_tpu_torch.train import dp as train_dp  # noqa: E402
from vae_equalizer_tpu_torch.utils import DpConfig  # noqa: E402

LAUNCHERS = {"c": "cma_dp_launch", "d": "cma_chunked_launch"}


def import_port(checkout: pathlib.Path, name: str = "parent_port") -> types.SimpleNamespace:
    """``ops/cma_kernel`` and ``ops/cma_frame_kernel`` of another checkout's
    port, imported under the package name ``name`` (its modules import each
    other relatively, so they stay within it); its kernels build into that
    checkout's build/kernels/."""
    pkg = checkout.resolve() / "vae_equalizer_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return types.SimpleNamespace(c=importlib.import_module(f"{name}.ops.cma_kernel"),
                                 d=importlib.import_module(f"{name}.ops.cma_frame_kernel"),
                                 build=importlib.import_module(f"{name}.ops._build"),
                                 train=importlib.import_module(f"{name}.train.dp"))


def setup(dev, R: int = chip_smoke.CMA_RUNS):
    """One 10,000-symbol frame of DpConfig()'s channel for R runs and a
    perturbed Dirac start (seeds 1234 and 99)."""
    cfg = DpConfig()
    _, _, sim, _, _ = train_dp._setup(cfg, cfg.n_frame_max, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    thetas = train_dp._frame_inputs(cfg, dev)
    rx = sim(gen, thetas[0], R)[0]
    rng = torch.Generator(device=dev)
    rng.manual_seed(99)
    M = cfg.m_est
    h = dirac_taps_dp(M, dev) + 0.01 * torch.randn((R, 2, 2, 2, M), generator=rng, device=dev)
    return cfg, rx, h.contiguous()


def cases(cfg, rx, h) -> dict:
    """{name: (kernel, args)}: C at CMA's lr, D for CMAbatch and CMAflex."""
    out = {"C": ("c", (rx, cfg.R, h, chip_smoke.CMA_VARIANTS["CMA"][1], cfg.sps))}
    for v, S in (("CMAbatch", cfg.batch_len), ("CMAflex", cfg.flex_step)):
        out[f"D {v}"] = ("d", (rx, cfg.R, h, chip_smoke.CMA_VARIANTS[v][1], cfg.batch_len, S, cfg.sps))
    return out


def call(port, kernel: str, args):
    return port.c.cma_dp_kernel(*args) if kernel == "c" else port.d.cma_chunked_frame(*args)


def hold(got, want, what: str, missed: list) -> dict:
    """got against want at phase 7 / 8's tolerances; a miss goes to ``missed``."""
    errs: dict = {}
    try:
        for t_name, g_, w_ in zip(("out", "h", "e"), got, want):
            chip_smoke._check(t_name, g_, w_, 1e-4, 1e-6 * float(w_.abs().max()), errs)
        print(f"{what}: within phase 7 / 8's tolerances: {chip_smoke._fmt(errs)}", flush=True)
    except AssertionError as e:
        missed.append(f"{what}: {e}")
        print(missed[-1], flush=True)
    return errs


def whole_turns(ports: dict, cfg) -> dict:
    """Each CMA variant's 170-frame experiment (R = 5, seed 0) per port, in
    turns (parent, new, new, parent): {variant: {port: [wall s, ...]}}, and
    each run's last-20-frame constellation SER."""
    out = {}
    for v, (mode, lr_v, _) in chip_smoke.CMA_VARIANTS.items():
        cfg_v = dataclasses.replace(cfg, loss_type=v, lr=lr_v)
        out[v] = {who: [] for who in ports}
        sers = {who: [] for who in ports}
        for who in ("parent", "new", "new", "parent"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = ports[who].train.run_cma_dp(cfg_v, seed=0, device="cuda", runs=chip_smoke.CMA_RUNS,
                                              use_pallas=mode)
            torch.cuda.synchronize()
            out[v][who].append(time.perf_counter() - t0)
            sers[who].append(float(res["ser"][:, :2, -20:].mean()))
        print(f"whole {v} (parent, new, new, parent): parent {out[v]['parent'][0]:.3f} / "
              f"{out[v]['parent'][1]:.3f} s, new {out[v]['new'][0]:.3f} / {out[v]['new'][1]:.3f} s; "
              f"frame wall {1e3 * min(out[v]['parent']) / cfg.num_frames:.3f} -> "
              f"{1e3 * min(out[v]['new']) / cfg.num_frames:.3f} ms (best of each); const SER "
              f"parent {sers['parent']}, new {sers['new']}", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    ap.add_argument("--whole", action="store_true", help="also time the 170-frame CMA experiments")
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    _, secs, log = _build.build()
    lines = log.splitlines()
    cma_lines = [ln.strip() for i, ln in enumerate(lines) if "cma_" in ln
                 or (i > 0 and "cma_" in lines[i - 1]) or (i > 1 and "cma_" in lines[i - 2])]
    print(f"build {secs:.1f} s; cma ptxas:", " | ".join(cma_lines)[:3000], flush=True)
    dev = torch.device("cuda")
    cfg, rx, h = setup(dev)
    new = types.SimpleNamespace(c=ck, d=cfk, build=_build, train=train_dp)
    parent = import_port(args.parent) if args.parent is not None else None
    report, missed = {"card": card}, []
    for name, (kernel, c_args) in cases(cfg, rx, h).items():
        clocks = ck.cma_dp_clocks(*c_args) if kernel == "c" else cfk.cma_chunked_clocks(*c_args)
        one, two = call(new, kernel, c_args), call(new, kernel, c_args)
        same = all(torch.equal(u, v) for u, v in zip(one, two))
        chip_smoke._line(f"clocks {name}", bit_identical=same, **chip_smoke._clocks_kv(clocks))
        report[name] = {"clocks": clocks, "bit_identical": same}
        if not same:
            missed.append(f"{name}: two launches differ")
        plain = ck.cma_dp_plain(*c_args) if kernel == "c" else cfk.cma_chunked_frame_plain(*c_args)
        report[name]["errs_vs_plain"] = hold(one, plain, f"plain {name}", missed)
        if parent is not None:
            want = call(parent, kernel, c_args)
            torch.cuda.synchronize()
            report[name]["errs_vs_parent"] = hold(one, want, f"parent {name}", missed)
    variants = {}
    for spec in args.variant:
        v_name, v_dir = spec.split("=", 1)
        variants[v_name] = import_port(pathlib.Path(v_dir), f"variant_{len(variants)}")
    for v_name, port in variants.items():
        for name, (kernel, c_args) in cases(cfg, rx, h).items():
            clocks = (port.c.cma_dp_clocks(*c_args) if kernel == "c"
                      else port.d.cma_chunked_clocks(*c_args))
            chip_smoke._line(f"clocks {v_name} {name}", **chip_smoke._clocks_kv(clocks))
            plain = ck.cma_dp_plain(*c_args) if kernel == "c" else cfk.cma_chunked_frame_plain(*c_args)
            report.setdefault(v_name, {})[name] = {
                "clocks": clocks, "errs_vs_plain": hold(call(port, kernel, c_args), plain,
                                                        f"{v_name} vs plain {name}", missed)}
    ports = {**({"parent": parent} if parent is not None else {}), "new": new, **variants}
    if len(ports) > 1:
        order = list(ports) + list(ports)[::-1]
        for name, (kernel, c_args) in cases(cfg, rx, h).items():
            t = {who: {"call": [], "launch": []} for who in ports}
            for who in order:
                fn = lambda: call(ports[who], kernel, c_args)  # noqa: E731
                t[who]["call"].append(chip_smoke._time_ms(fn, reps=args.reps))
                t[who]["launch"].append(chip_smoke._launch_alone_ms(fn, LAUNCHERS[kernel], args.reps,
                                                                    ports[who].build))
            report.setdefault("turns_ms", {})[name] = t
            print(f"turns {name} (order {','.join(order)}): " + "; ".join(
                f"{who} call {v['call'][0]:.4f} / {v['call'][1]:.4f} ms, launch alone "
                f"{v['launch'][0]:.4f} / {v['launch'][1]:.4f} ms" for who, v in t.items()), flush=True)
    if args.whole and parent is not None:
        report["whole_s"] = whole_turns({"parent": parent, "new": new}, cfg)
    print(json.dumps(report), flush=True)
    if missed:
        raise SystemExit("; ".join(missed))


if __name__ == "__main__":
    main()
