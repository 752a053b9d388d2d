"""What the benchmark's per-cell tests do, as functions of the harness
(``core``) and a cell's name, so that the cells in ``BENCHMARK.json`` and a
cell of a kind that a later change adds as new files run the same code.

What the tests know of a traffic kind sits in its support file,
``benchmark/tests/kinds/<kind>.py``, found by the mix's ``kind`` as the
harness finds ``benchmark/kinds/<kind>.py``. It holds:

* ``shrink(spec)``: the cell at a size a CPU runs in seconds, without the
  limits that size cannot meet;
* ``CPU_SECONDS``: the window a CPU run of the shrunk cell is given;
* ``launches(spec)``: each hand kernel the cell times, as ``(kernel,
  frozen, original, bound_by)``: its (operations, bytes) from the
  benchmark's frozen counts, the original count they are held to, and
  which of the two bounds it on the card;
* ``control(spec, seed, device, seconds)``: the numbers the check compares,
  with the plain reference put in the program's place one precision below
  the configuration's; ``tested_control(spec, seed, device)``: the same at
  the size its test reads it;
* ``FAULTS``, ``FULL_SIZE_ONLY`` and ``fault(name)``: the faults the kind
  plants under its timed path, those of them that only a run at the cell's
  own size shows, and a context manager that plants one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import time

import pytest

# the seeds the tests give a cell's runs
SOUND_SEED, FAULT_SEED, CONTROL_SEED, FULL_SIZE_SEED = 2**31 + 5, 2**31 + 6, 2**31 + 17, 2**31 + 19


@contextlib.contextmanager
def patched(module, name: str, fn):
    """``module.name`` replaced by ``fn`` for the block's duration."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def support_path(core, spec: dict) -> pathlib.Path:
    return core.BENCH / "tests" / "kinds" / f"{spec['mix']['kind']}.py"


def has_support(core, spec: dict) -> bool:
    return support_path(core, spec).is_file()


def support(core, spec: dict):
    """The support file of the cell's kind; a test of a cell whose kind has
    none skips, and ``test_kinds.py: test_every_kind_has_a_support_file``
    fails naming the file."""
    path = support_path(core, spec)
    if not path.is_file():
        pytest.skip(f"no support file {path.relative_to(core.ROOT)} for kind "
                    f"{spec['mix']['kind']!r}: test_every_kind_has_a_support_file fails for it")
    return core.load_module(path, f"benchmark_tests_kind_{spec['mix']['kind']}")


def names(core) -> list[str]:
    return [w["name"] for w in core.manifest()["workloads"]]


def faults(core, full_size: bool) -> list[tuple[str, str]]:
    """(cell, fault) of every cell whose kind has a support file: the faults
    a shrunk run on the CPU shows, or with ``full_size`` those that only a
    run at the cell's own size shows. Read while the tests are collected."""
    man, out = core.manifest(), []
    for w in names(core):
        spec = core.cell_spec(man, w)
        if has_support(core, spec):
            sup = support(core, spec)
            out += [(w, f) for f in sup.FAULTS if (f in sup.FULL_SIZE_ONLY) == full_size]
    return out


def shrunk(core, resolve):
    """``core.cell_spec`` whose cells come out at their kinds' CPU sizes."""
    def spec(man, workload):
        s = resolve(man, workload)
        return support(core, s).shrink(s)
    return spec


def run(core, workload: str, seed: int, device: str = "cpu", seconds: float | None = None) -> dict:
    """One run of the cell past the harness's look for a card; on the CPU
    for the kind's ``CPU_SECONDS`` unless ``seconds`` says otherwise."""
    if seconds is None:
        seconds = support(core, core.cell_spec(core.manifest(), workload)).CPU_SECONDS
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=0)
    return core.run(args, time.perf_counter(), device=device)


def check_resolves(core, workload: str) -> None:
    """The cell's files are found by name; it reports setup_s, another
    end-to-end metric and a per-layer metric, each with a reader."""
    man = core.manifest()
    spec = core.cell_spec(man, workload)
    assert hasattr(spec["kind"], "Cell")
    assert set(spec["limits"]["limits"]), "the check compares at least one number"
    e2e = {m["name"] for m in core.metrics_of(man, workload, trace=False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = core.metrics_of(man, workload, trace=True)
    assert layer
    for m in layer:
        path = core.BENCH / "metrics" / f"{m['name']}.py"
        assert callable(core.load_module(path, "m_" + m["name"].replace(".", "_")).read)
    for c in man["configs"]:
        cfg = json.loads((core.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]


def check_counts(core, workload: str) -> None:
    """Each hand kernel the cell times: the benchmark's frozen count equal
    to the original at the cell's shapes, and its bound by the benchmark's
    peaks equal to ``chip_smoke.py``'s."""
    import chip_smoke

    from benchmark.harness import counts

    assert counts.F32_FLOPS == chip_smoke.F32_FLOPS and counts.HBM_BYTES == chip_smoke.HBM_BYTES
    spec = core.cell_spec(core.manifest(), workload)
    found = support(core, spec).launches(spec)
    assert found, f"{workload} counts no hand kernel"
    for kernel, frozen, original, bound_by in found:
        assert frozen == original, (kernel, frozen, original)
        b = chip_smoke._bound(*frozen)
        assert counts.bound(*frozen) == {k: b[k] for k in ("bound_ms", "bound_by")}, kernel
        assert b["bound_by"] == bound_by, (kernel, b)


def check_sound_run(core, workload: str) -> None:
    """A sound run is correct and reports every end-to-end metric of the cell."""
    res = run(core, workload, SOUND_SEED)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] >= 1 and res["failed"] == 0
    e2e = {m["name"] for m in core.metrics_of(core.manifest(), workload, trace=False)}
    assert "setup_s" in e2e and e2e <= set(res["metrics"]), (e2e, res["metrics"])


def check_fault(core, workload: str, fault: str) -> None:
    with support(core, core.cell_spec(core.manifest(), workload)).fault(fault):
        res = run(core, workload, FAULT_SEED)
    assert not res["correct"], res["checks"]


def check_control(core, workload: str, device: str) -> None:
    """The control reads above a limit of the cell's check."""
    spec = core.cell_spec(core.manifest(), workload)
    readings = support(core, spec).tested_control(spec, CONTROL_SEED, device)
    limits = spec["limits"]["limits"]
    assert any(v > limits[k] for k, v in readings.items()), readings


def check_full_size_fault(core, workload: str, fault: str, device: str) -> None:
    """A fault that only the cell's own size shows, in a whole run of it."""
    with support(core, core.cell_spec(core.manifest(), workload)).fault(fault):
        res = run(core, workload, FULL_SIZE_SEED, device, seconds=1.0)
    assert not res["correct"], res["checks"]
