"""A short check of kernel E on the card, before chip_smoke.py: its phase
clocks, and this tree against a parent checkout.

Builds every kernel library and prints the butterfly library's ptxas
figures per entry (registers, stack, spills). At chip_smoke.py's phase 15
shapes (``DpConfig()``: 64-QAM, M = 25; one output pass over a 2,000-symbol
block and the M - 1 tail, sps 2 and sps 1; taps near the butterfly's start
and unit normal samples from chip_smoke's seed 31): kernel E's clock64()
cycles per phase of block 0's thread 0 (``butterfly_clocks``), whether two
launches on the same inputs give the same bits, and E held to its plain
version at phase 15's tolerances (q rtol 5e-4 / atol 2e-6, out rtol 1e-4 /
atol 1e-6, the JAX test's). It also times an empty kernel launched at E's
grid and the parent's (``chip_smoke._empty_launch_ms``), the floor of a
launch on this card.
With ``--parent DIR``, a checkout of the previous commit (``git archive``
unpacked under ``build/``), it imports that checkout's port under another
name, so its kernel runs through its own wrapper and signature, holds this
tree's E to it at the same tolerances (and says whether the two agree bit
for bit), then times the two in turns (parent, this tree, this tree,
parent; CUDA events, the median of each turn): E's whole wrapper call and
its launch alone (``chip_smoke._launch_alone_ms``); then each one's device
time per launch from torch.profiler, and the streaming receiver's step
profiled (device ms per step by kernel, the device's busy share). ``--variant NAME=DIR``
(repeatable) adds a copy of this tree's package with one design change
under ``DIR``: its clocks and errors are printed, and it joins the turns. A
tolerance missed is reported at once and raised after the timings. Run
from the repository root on a machine with a card: ``python
tools/first_check_e.py [--parent DIR] [--variant NAME=DIR ...] [--reps N]``.
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

import chip_smoke  # noqa: E402
from vae_equalizer_tpu_torch.core import demapper_noise_var, make_constellation  # noqa: E402
from vae_equalizer_tpu_torch.models import butterfly_init  # noqa: E402
from vae_equalizer_tpu_torch.ops import _build  # noqa: E402
from vae_equalizer_tpu_torch.ops import butterfly_kernel as bk  # noqa: E402
from vae_equalizer_tpu_torch.utils import DpConfig  # noqa: E402

BLOCK = 2000  # symbols per streaming block (chip_smoke phases 15-16)


def import_port(checkout: pathlib.Path, name: str = "parent_port") -> types.SimpleNamespace:
    """Kernel E's wrapper of another checkout's port, imported under the
    package name ``name``; its kernels build into that checkout's
    build/kernels/."""
    pkg = checkout.resolve() / "vae_equalizer_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return types.SimpleNamespace(e=importlib.import_module(f"{name}.ops.butterfly_kernel"),
                                 build=importlib.import_module(f"{name}.ops._build"))


def setup(dev) -> dict:
    """Phase 15's inputs at sps 2 and 1: {sps: (w, x, amps, var, nu_sc, sps)}."""
    cfg = DpConfig()
    M = cfg.m_est
    const = make_constellation(cfg.mod, cfg.nu)
    amps = torch.from_numpy(const.amps).to(dev)
    var = torch.full((2,), demapper_noise_var(const, cfg.snr_db), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    args = {}
    for sps in (2, 1):
        w = (butterfly_init(M, dev) + 0.05 * torch.randn((2, 4, M), generator=gen, device=dev)).contiguous()
        x = torch.randn((2, 2, M - 1 + BLOCK * sps), generator=gen, device=dev)
        args[sps] = (w, x, amps, var, const.nu_sc, sps)
    return args


def hold(got, want, errs: dict, tag: str) -> None:
    """Phase 15's tolerances."""
    chip_smoke._check(f"{tag} q", got[0], want[0], 5e-4, 2e-6, errs)
    chip_smoke._check(f"{tag} out", got[1], want[1], 1e-4, 1e-6, errs)


def check_port(port, args: dict, name: str, missed: list) -> dict:
    """Clocks per phase (where the port has them), two launches bit for bit,
    and the port against the plain version, per sps; printed and returned."""
    out = {}
    for sps, a in args.items():
        one, two = port.e.vae_le_dp_forward_fused(*a), port.e.vae_le_dp_forward_fused(*a)
        same = all(torch.equal(u, v) for u, v in zip(one, two))
        rec = {"bit_identical": same}
        if hasattr(port.e, "butterfly_clocks"):
            rec["clocks"] = port.e.butterfly_clocks(*a)
            chip_smoke._line(f"clocks {name} sps {sps}", bit_identical=same,
                             **chip_smoke._clocks_kv(rec["clocks"]))
        if not same:
            missed.append(f"{name} sps {sps}: two launches differ")
        errs: dict = {}
        try:
            hold(one, bk.vae_le_dp_forward_plain(*a), errs, f"sps {sps}")
            print(f"{name} vs plain, sps {sps}: within phase 15: {chip_smoke._fmt(errs)}", flush=True)
        except AssertionError as e:
            missed.append(f"{name} vs plain, sps {sps}: {e}")
            print(missed[-1], flush=True)
        rec["errs_vs_plain"] = errs
        out[sps] = rec
    return out


def device_ms(call, reps: int, name: str) -> tuple:
    """Mean device time of the kernels whose name holds ``name`` over ``reps``
    calls, from torch.profiler (CUPTI), and their count per call; (nan, 0)
    where the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    tot, n = 0.0, 0
    for ev in prof.key_averages():
        if name in ev.key:
            tot += getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
            n += ev.count
    return (1e-3 * tot / n if n and tot else float("nan")), n / reps


def stream_profile(reps: int) -> dict:
    """The streaming receiver's step on phase 16's shapes (DpConfig(): one
    2,000-symbol block of unit normal samples, route B), profiled over
    ``reps`` steps: device ms per step by kernel, and the device's busy
    share of the steps' wall (host clock around the synchronized steps)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from vae_equalizer_tpu_torch.core import demapper_noise_var, make_constellation
    from vae_equalizer_tpu_torch.models.streaming import StreamingReceiver

    cfg = DpConfig()
    const = make_constellation(cfg.mod, cfg.nu)
    dev = torch.device("cuda")
    var = torch.full((2,), demapper_noise_var(const, cfg.snr_db), dtype=torch.float32, device=dev)
    rxr = StreamingReceiver(torch.from_numpy(const.amps), torch.as_tensor(const.P), var, const.nu_sc,
                            m_est=cfg.m_est, sps=cfg.sps, block_len=BLOCK, lr=cfg.lr, use_pallas=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(32)
    blk = 0.7 * torch.randn((2, 2, BLOCK * cfg.sps), generator=gen, device=dev)
    state = rxr.step(rxr.init(), blk)[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            state = rxr.step(state, blk)[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {}
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0.0)
        if dt:
            by_kernel[ev.key[:60]] = 1e-3 * dt / reps
    busy = sum(by_kernel.values())
    return {"route": rxr.adapt_route, "wall_ms_per_step": 1e3 * wall / reps,
            "device_ms_per_step": busy, "busy_share": busy / (1e3 * wall / reps),
            "by_kernel_ms": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1]))}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    _, secs, log = _build.build()
    print(f"build {secs:.1f} s; butterfly ptxas:", flush=True)
    entry = None
    for ln in log.splitlines():  # per entry: registers, stack, spills
        m = re.search(r"Compiling entry function '(\w*butterfly\w*|\w*empty\w*)'", ln)
        if m or "Compiling entry" in ln:
            entry = m.group(1) if m else None
        elif entry and ("stack frame" in ln or "registers" in ln):
            print(f"  {entry}: {ln.split(':', 1)[-1].strip()}", flush=True)
    dev = torch.device("cuda")
    st = setup(dev)
    new = types.SimpleNamespace(e=bk, build=_build)
    parent = import_port(args.parent) if args.parent is not None else None
    variants = {}
    for spec in args.variant:
        v_name, v_dir = spec.split("=", 1)
        variants[v_name] = import_port(pathlib.Path(v_dir), f"variant_{len(variants)}")
    report, missed = {"card": card}, []
    for name, port in {"new": new, **variants}.items():
        report[name] = check_port(port, st, name, missed)
    if parent is not None:
        report["vs_parent"] = {}
        for sps, a in st.items():
            got, want = bk.vae_le_dp_forward_fused(*a), parent.e.vae_le_dp_forward_fused(*a)
            errs: dict = {}
            same = all(torch.equal(u, v) for u, v in zip(got, want))
            try:
                hold(got, want, errs, f"sps {sps}")
            except AssertionError as e:
                missed.append(f"new vs parent, sps {sps}: {e}")
            report["vs_parent"][sps] = {"bit_identical": same, "errs": errs}
            print(f"new vs parent, sps {sps}: bit for bit {same}; {chip_smoke._fmt(errs)}", flush=True)
    report["empty_launch_ms"] = {f"{b}x{t}": chip_smoke._empty_launch_ms(b, t, args.reps)
                                 for b, t in ((1, 32), (8, 256), (63, 128), (126, 64))}
    print("empty launch (blocks x threads): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in report["empty_launch_ms"].items()), flush=True)
    ports = {**({"parent": parent} if parent is not None else {}), "new": new, **variants}
    order = list(ports) + list(ports)[::-1]
    report["turns_ms"] = {}
    for sps, a in st.items():
        t = {who: {"call": [], "launch": []} for who in ports}
        for who in order:
            call = lambda: ports[who].e.vae_le_dp_forward_fused(*a)  # noqa: E731
            t[who]["call"].append(chip_smoke._time_ms(call, reps=args.reps))
            t[who]["launch"].append(chip_smoke._launch_alone_ms(call, "butterfly_demap_launch",
                                                                args.reps, ports[who].build))
        report["turns_ms"][f"sps {sps}"] = t
        print(f"turns sps {sps} (order {','.join(order)}): " + "; ".join(
            f"{who} " + " / ".join(f"{v:.4f}" for v in tt["call"]) + " ms, launch alone "
            + " / ".join(f"{v:.4f}" for v in tt["launch"]) + " ms" for who, tt in t.items()),
            flush=True)
    report["device_ms"] = {}
    for who, port in ports.items():
        for sps, a in st.items():
            report["device_ms"][f"{who} sps {sps}"] = device_ms(
                lambda: port.e.vae_le_dp_forward_fused(*a), args.reps, "butterfly_demap")
    lib, stream = _build.load(), _build.stream(dev)
    report["device_ms"]["empty 63x128"] = device_ms(
        lambda: _build.check(lib.butterfly_empty_launch(63, 128, stream), "empty"), args.reps, "empty_kernel")
    print("device ms per launch (torch.profiler), launches per call: " + "; ".join(
        f"{k} {v[0]:.4f} ({v[1]:g})" for k, v in report["device_ms"].items()), flush=True)
    report["stream_profile"] = stream_profile(20)
    print(f"stream profile: {json.dumps(report['stream_profile'])}", flush=True)
    print(json.dumps(report), flush=True)
    if missed:
        raise SystemExit("; ".join(missed))


if __name__ == "__main__":
    main()
