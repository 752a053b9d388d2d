"""A short check of kernels F and G on the card, before chip_smoke.py: their
phase clocks, and this tree against a parent checkout.

Builds every kernel library and prints the siso library's ptxas figures
per entry (registers, stack, spills). At chip_smoke.py's phase 10 / 11
shapes (``AwgnVaeLeConfig()``: 64-QAM, M = 25, bl 350, 3 minibatches per
epoch, h1 at 24 dB, R = 20 runs from chip_smoke's perturbed start and
channel draws): kernel F's clock64() cycles per phase of one minibatch and
kernel G's per step over a 10-epoch slice (run 0's block, thread 0;
``siso_step_clocks`` / ``siso_clocks``), whether two launches of each on the
same inputs give the same bits, and both held to their plain versions at
phase 10 / 11a / 11b's tolerances (F: loss rtol 1e-5, gw / gh / q / out
rtol 1e-4 over 1e-4 of each tensor's scale; G over 2 epochs: losses rtol
1e-4, w / h / eval slots rtol 1e-2 over 1e-4; over 10 epochs from a
50-epoch warm state: losses rtol 1e-3, eval-slot decisions 99.9 % equal).
With ``--parent DIR``, a checkout of the previous commit (``git archive``
unpacked under ``build/``), it imports that checkout's port under another
name, so its kernels run through their own wrappers and signatures, holds
this tree's F and G to it at the same tolerances and kernel H's outputs to
the parent's bit for bit (Net and Net_BN, chip_smoke phase 13's 20-epoch
slice: H includes siso_step.cuh). Then it times the two in turns (parent,
this tree, this tree, parent; CUDA events, the median of each turn): F's
whole wrapper call and its launch alone (``chip_smoke._launch_alone_ms``),
G's 10-epoch slice and, with ``--whole``, G's whole 1,500-step experiment.
``--variant NAME=DIR`` (repeatable) adds a copy of this tree's package with
one design change under ``DIR``: its clocks and errors against the plain
versions are printed, and it joins the turns. A tolerance missed is
reported at once and raised after the timings. Run from the repository root
on a machine with a card: ``python tools/first_check_fg.py [--parent DIR]
[--whole] [--variant NAME=DIR ...] [--reps N]``.
"""

import argparse
import importlib
import importlib.util
import json
import pathlib
import re
import subprocess
import sys
import types

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402
import first_check_h  # noqa: E402
from vae_equalizer_tpu_torch.models import dirac_taps_siso, siso_fir_init, vae_le_siso_forward  # noqa: E402
from vae_equalizer_tpu_torch.ops import _build  # noqa: E402
from vae_equalizer_tpu_torch.ops import elbo_siso_kernel as esk  # noqa: E402
from vae_equalizer_tpu_torch.ops import nn_frame_kernel as nfk  # noqa: E402
from vae_equalizer_tpu_torch.ops import siso_frame_kernel as sfk  # noqa: E402
from vae_equalizer_tpu_torch.train import awgn as train_awgn  # noqa: E402
from vae_equalizer_tpu_torch.utils import AwgnVaeLeConfig  # noqa: E402


def import_port(checkout: pathlib.Path, name: str = "parent_port") -> types.SimpleNamespace:
    """Kernels F, G and H's wrappers of another checkout's port, imported under
    the package name ``name`` (its modules import each other relatively, so
    they stay within it); its kernels build into that checkout's
    build/kernels/."""
    pkg = checkout.resolve() / "vae_equalizer_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return types.SimpleNamespace(f=importlib.import_module(f"{name}.ops.elbo_siso_kernel"),
                                 g=importlib.import_module(f"{name}.ops.siso_frame_kernel"),
                                 h=importlib.import_module(f"{name}.ops.nn_frame_kernel"),
                                 build=importlib.import_module(f"{name}.ops._build"))


def setup(dev, R: int = chip_smoke.AWGN_RUNS) -> dict:
    """chip_smoke phases 10-11's start (seed 77) and channel rows (seed 4321)."""
    cfg = AwgnVaeLeConfig()
    const, sims, amps, P, var = train_awgn._setup(cfg, dev)
    M, bl, nb = cfg.m_est, cfg.batch_len, cfg.n_train // cfg.batch_len
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    rng = torch.Generator(device=dev)
    rng.manual_seed(77)
    draws = lambda kind, index, runs: sims[kind].draws(gen, runs)
    rx = lambda n_ep: train_awgn._frame_train_data(sims["train"], draws, R, n_ep)
    w0 = siso_fir_init(M, dev) + 0.01 * torch.randn((R, 1, 2, M), generator=rng, device=dev)
    h0 = dirac_taps_siso(M, dev) + 0.01 * torch.randn((R, 2, M), generator=rng, device=dev)
    c = (amps, const.amp_mean, var, P)
    start = (w0, h0, sfk.siso_frame_opt_init({"w": w0, "h": h0}))
    rx_v = sims["valid"](gen, R)[0]
    st = dict(cfg=cfg, c=c, start=start, kw=dict(bl_sym=bl, n_batches=nb, epe=cfg.epe),
              f_args=(w0, h0, rx(1)[:, 0, :, : 2 * bl].contiguous(), *c),
              a_rows=rx(2), warm_rows=rx(chip_smoke.AWGN_WARM_EPOCHS), b_rows=rx(10),
              decide=lambda w: vae_le_siso_forward(w, rx_v, amps, const.amp_mean, var, 2)[0]
              .unflatten(-2, (2, -1)).argmax(-2))
    st["whole_rows"] = rx(cfg.num_epochs)
    return st


def g_args(st: dict, start, rows) -> tuple:
    return (*start, rows, *st["c"], st["cfg"].lr)


def hold(st: dict, f_port, g_port, what: str, missed: list, want_f=None, want_g=None) -> dict:
    """A port's F and G against the given outputs (the plain versions' by
    default) at phases 10 / 11a / 11b's tolerances; a miss goes to ``missed``."""
    kw, errs = st["kw"], {}
    try:
        got = f_port.vae_siso_loss_and_grad(*st["f_args"])
        want = want_f(st["f_args"]) if want_f else esk.vae_siso_loss_and_grad_plain(*st["f_args"])
        chip_smoke._check("10 loss", got[0], want[0], 1e-5, 0.0, errs)
        for name, g_, w_ in zip(("gw", "gh", "q", "out"), got[1:], want[1:]):
            chip_smoke._check(f"10 {name}", g_, w_, 1e-4, 1e-4 * float(w_.abs().max()), errs)
        plain_g = want_g or (lambda a, **k: sfk.vae_siso_experiment_train_plain(*a, **k))
        a_args = g_args(st, st["start"], st["a_rows"])
        got, want = g_port.vae_siso_experiment_train(*a_args, **kw), plain_g(a_args, **kw)
        chip_smoke._check("11a losses", got[3], want[3], 1e-4, 0.0, errs)
        for i, name in ((0, "w"), (1, "h"), (4, "w_ev"), (5, "h_ev")):
            chip_smoke._check(f"11a {name}", got[i], want[i], 1e-2, 1e-4, errs)
        warm = sfk.vae_siso_experiment_train(*g_args(st, st["start"], st["warm_rows"]), **kw)
        b_args = g_args(st, warm[:3], st["b_rows"])
        step0 = chip_smoke.AWGN_WARM_EPOCHS * kw["n_batches"]
        got, want = g_port.vae_siso_experiment_train(*b_args, **kw, step0=step0), \
            plain_g(b_args, **kw, step0=step0)
        chip_smoke._check("11b losses", got[3], want[3], 1e-3, 0.0, errs)
        agree = min(float((st["decide"](got[4][i]) == st["decide"](want[4][i])).float().mean())
                    for i in range(got[4].shape[0]))
        errs["11b slot_dec_agree"] = (agree, 0.0)
        if agree < 0.999:
            raise AssertionError(f"11b eval-slot decision agreement {agree:.5f} < 0.999")
        print(f"{what}: within phases 10 / 11a / 11b: {chip_smoke._fmt(errs)}", flush=True)
    except AssertionError as e:
        missed.append(f"{what}: {e}")
        print(missed[-1], flush=True)
    return errs


def clocks_of(port, st: dict, name: str) -> dict:
    """F's clocks per phase of one minibatch and G's per step over the 10-epoch
    slice, and two launches of each bit for bit; printed and returned."""
    kw = st["kw"]
    b_args = g_args(st, st["start"], st["b_rows"])
    out = {}
    for k, clk, call in (
            ("F", lambda: port.f.siso_step_clocks(*st["f_args"]),
             lambda: port.f.vae_siso_loss_and_grad(*st["f_args"])),
            ("G", lambda: port.g.siso_clocks(*b_args, **kw),
             lambda: port.g.vae_siso_experiment_train(*b_args, **kw))):
        one, two = call(), call()
        flat = lambda o: [t for x in o for t in (x.values() if isinstance(x, dict) else (x,))]
        same = all(torch.equal(u, v) for u, v in zip(flat(one), flat(two)))
        clocks = clk()
        chip_smoke._line(f"clocks {name} {k}", bit_identical=same, **chip_smoke._clocks_kv(clocks))
        out[k] = {"clocks": clocks, "bit_identical": same}
    return out


def h_bitwise(parent, missed: list) -> dict:
    """Kernel H of this tree against the parent's on phase 13's 20-epoch slice,
    Net and Net_BN: every output bit for bit."""
    out = {}
    for bn_on in (False, True):
        st = first_check_h.setup(bn_on, torch.device("cuda"))
        t_args = first_check_h.args_of(st, st["rx"](chip_smoke.NN_TIMED_EPOCHS))
        got = nfk.vae_nn_experiment_train(*t_args, **st["kw"])
        want = parent.h.vae_nn_experiment_train(*t_args, **st["kw"])
        same = all(torch.equal(u, v) for x, y in zip(got, want)
                   for u, v in (zip(x.values(), y.values()) if isinstance(x, dict) else ((x, y),)))
        variant = "Net_BN" if bn_on else "Net"
        print(f"kernel H {variant} vs parent, {chip_smoke.NN_TIMED_EPOCHS} epochs: bit for bit {same}",
              flush=True)
        out[variant] = same
        if not same:
            missed.append(f"kernel H {variant}: outputs differ from the parent's")
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    ap.add_argument("--whole", action="store_true", help="also time G's whole 500-epoch experiment")
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, secs, log = _build.build()
    print(f"build {secs:.1f} s; siso ptxas:", flush=True)
    entry = None
    for ln in log.splitlines():  # per entry: registers, stack, spills
        m = re.search(r"Compiling entry function '.*?(vae_siso_\w+?_kernelIL\w+?E)", ln)
        if m or "Compiling entry" in ln:
            entry = m.group(1) if m else None
        elif entry and ("stack frame" in ln or "registers" in ln):
            print(f"  {entry}: {ln.split(':', 1)[-1].strip()}", flush=True)
    dev = torch.device("cuda")
    st = setup(dev)
    new = types.SimpleNamespace(f=esk, g=sfk, h=nfk, build=_build)
    parent = import_port(args.parent) if args.parent is not None else None
    variants = {}
    for spec in args.variant:
        v_name, v_dir = spec.split("=", 1)
        variants[v_name] = import_port(pathlib.Path(v_dir), f"variant_{len(variants)}")
    report, missed = {"card": card}, []
    for name, port in {"new": new, **variants}.items():
        report[name] = clocks_of(port, st, name)
        for k in ("F", "G"):
            if not report[name][k]["bit_identical"]:
                missed.append(f"{name} {k}: two launches differ")
        report[name]["errs_vs_plain"] = hold(st, port.f, port.g, f"{name} vs plain", missed)
    if parent is not None:
        report["errs_vs_parent"] = hold(
            st, esk, sfk, "new vs parent", missed,
            want_f=lambda a: parent.f.vae_siso_loss_and_grad(*a),
            want_g=lambda a, **k: parent.g.vae_siso_experiment_train(*a, **k))
        report["h_bitwise"] = h_bitwise(parent, missed)
    ports = {**({"parent": parent} if parent is not None else {}), "new": new, **variants}
    if len(ports) > 1:
        kw = st["kw"]
        order = list(ports) + list(ports)[::-1]
        cases = {"F call": (lambda p: p.f.vae_siso_loss_and_grad(*st["f_args"]), args.reps,
                            "vae_siso_step_launch"),
                 "G 10 epochs": (lambda p: p.g.vae_siso_experiment_train(
                     *g_args(st, st["start"], st["b_rows"]), **kw), 5, None)}
        if args.whole:
            cases["G whole"] = (lambda p: p.g.vae_siso_experiment_train(
                *g_args(st, st["start"], st["whole_rows"]), **kw), 3, None)
        report["turns_ms"] = {}
        for case, (fn, reps, launcher) in cases.items():
            t = {who: {"call": [], "launch": []} for who in ports}
            for who in order:
                call = lambda: fn(ports[who])  # noqa: E731
                t[who]["call"].append(chip_smoke._time_ms(call, reps=reps))
                if launcher:
                    t[who]["launch"].append(chip_smoke._launch_alone_ms(call, launcher, reps,
                                                                        ports[who].build))
            report["turns_ms"][case] = t
            print(f"turns {case} (order {','.join(order)}): " + "; ".join(
                f"{who} " + " / ".join(f"{v:.4f}" for v in tt["call"]) + " ms"
                + (", launch alone " + " / ".join(f"{v:.4f}" for v in tt["launch"]) + " ms"
                   if tt["launch"] else "") for who, tt in t.items()), flush=True)
    print(json.dumps(report), flush=True)
    if missed:
        raise SystemExit("; ".join(missed))


if __name__ == "__main__":
    main()
