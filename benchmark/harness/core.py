"""The benchmark's driver: one run of one cell.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a configuration
(``benchmark/configs/<config>.json``, the sizes as run) under a traffic mix
(``benchmark/traffic/<traffic>.json``, parameters that the generator of its
``kind``, ``benchmark/kinds/<kind>.py``, reads), with the limits of its
output check in ``benchmark/workloads/<cell>.json``. Per-layer metrics are
readers in ``benchmark/metrics/<metric>.py`` (``readers.py`` says what they
take). Everything is found by the names in ``BENCHMARK.json``, so a cell, a
mix, a configuration or a metric is added by adding files.

A run: check the cards, build the kind's inputs and warm every shape it
uses (set-up, ``setup_s``), run the timed window for ``--seconds``, read
the peak memory, make sure nothing loaded JAX or the JAX package, then hold
what the window produced against the plain reference
(``benchmark/reference/``) and print the result line. With ``--trace 1`` a
part of the window runs under ``torch.profiler`` and the line carries the
per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import pathlib
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
BENCH = ROOT / "benchmark"
# top-level module names that the process must not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "vae_equalizer_tpu")


class Fail(Exception):
    """A run that prints no result: the message goes to standard error."""

    def __init__(self, msg: str, code: int = 2):
        super().__init__(msg)
        self.code = code


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path, name: str):
    """A module of the benchmark found by file name (metric readers' names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_spec(man: dict, workload: str) -> dict:
    """The cell's entry, configuration, traffic mix, check limits and kind module."""
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise Fail(f"unknown workload {workload!r}; known: {', '.join(sorted(cells))}")
    w = cells[workload]
    cfg = load_json(BENCH / "configs" / f"{w['config']}.json")
    mix = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits = load_json(BENCH / "workloads" / f"{workload}.json")
    kind = load_module(BENCH / "kinds" / f"{mix['kind']}.py", f"benchmark_kind_{mix['kind']}")
    return {"cell": w, "config": cfg, "mix": mix, "limits": limits, "kind": kind}


def metrics_of(man: dict, workload: str, trace: bool) -> list[dict]:
    """The manifest's metrics that this cell reports: end-to-end with
    ``--trace 0``, per-layer with ``--trace 1``. A metric with a
    ``workloads`` key lists its cells; a per-layer metric without one goes
    with every cell that reports the end-to-end metric it moves."""
    e2e = [m for m in man["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names else [])]


def forbidden_loaded() -> list[str]:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX package's,
    compared whole (``vae_equalizer_tpu_torch`` is not ``vae_equalizer_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(args, t0: float, device: str = "cuda") -> dict:
    """One run: the result dict (without printing). ``device`` is the card
    for the command; the tests pass "cpu" to drive a run without one."""
    man = manifest()
    spec = cell_spec(man, args.workload)
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < spec["cell"]["chips"]):
        raise Fail(f"{args.workload} needs {spec['cell']['chips']} CUDA card(s); "
                   f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
                   f"device_count() = {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    try:
        import vae_equalizer_tpu_torch  # noqa: F401
    except ImportError as e:
        raise Fail(f"the program vae_equalizer_tpu_torch cannot be imported: {e}") from e
    from . import trace as tr

    t_imports = time.perf_counter() - t0
    cell = spec["kind"].Cell(spec["config"], spec["mix"], spec["limits"], args.seed, device)
    cell.setup()
    setup_s = time.perf_counter() - t0
    print(f"setup: {setup_s:.3f} s = imports {t_imports:.3f} s + the cell's inputs and warm-up "
          f"{setup_s - t_imports:.3f} s", file=sys.stderr)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    tracer = tr.Tracer(args.trace == 1, device)
    out = cell.window(args.seconds, tracer)
    if tracer.on:
        t = tracer.summary
        print(f"trace: {t.window_s:.6f} s window, {len(t.ops)} device operations, counters "
              f"{t.counters}; untraced rest {tracer.untraced}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    bad = forbidden_loaded()
    if bad:
        raise Fail("the process holds " + ", ".join(bad) + " after the window: the port must "
                   "not load JAX or the JAX package", code=3)
    checks = cell.check()
    correct = all(c["value"] <= c["limit"] for c in checks) and out["failed"] == 0
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    metrics = {}
    ran = types.SimpleNamespace(config=spec["config"], mix=spec["mix"], untraced=tracer.untraced)
    for m in metrics_of(man, args.workload, args.trace == 1):
        if args.trace:
            v = load_module(BENCH / "metrics" / f"{m['name']}.py",
                            "benchmark_metric_" + m["name"].replace(".", "_")).read(tracer.summary, ran)
        else:
            v = setup_s if m["name"] == "setup_s" else out["metrics"].get(m["name"])
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": spec["cell"]["chips"], "memory_peak_bytes": int(peak)}
    if args.trace:
        dev.update(busy_s=tracer.summary.busy_s, window_s=tracer.summary.window_s)
        result["device"] = dev
        result["breakdown"] = tracer.summary.breakdown()
    else:
        result["device"] = dev
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result


def main(argv, t0: float) -> int:
    args = parse(argv)
    try:
        result = run(args, t0)
    except Fail as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return e.code
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0
