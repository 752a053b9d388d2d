"""Every traffic kind has the tests' support file, and a cell of a new kind
arrives as new files: on a copy of the benchmark, the toy kind of
``toy_kind/`` (a kind, its support file, reference, frozen count,
configuration, mix, limits, reader, and a toy program) plus its entries in
BENCHMARK.json pass the same checks as the cells of the manifest, with
every file that was there before left byte for byte as it was."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark.harness import core
from benchmark.tests import cells

from .conftest import ROOT

TOY = core.BENCH / "tests" / "toy_kind"
TOY_CELL = "toy.r4"
TOY_SUPPORT = "benchmark/tests/kinds/toy.py"
# pytest's options from the repository's pytest.ini, which the copy lacks
PYTEST = [sys.executable, "-m", "pytest", "benchmark/tests", "-q", "-p", "no:cacheprovider",
          "-p", "no:jaxtyping", "-p", "no:xdist", "-p", "no:hypothesispytest",
          "-o", "markers=requires_cuda: needs a CUDA card"]

# the helpers the per-cell tests run, on the toy cell, in the copy
_TOY_CHECKS = """
import json, pathlib, sys
import torch
torch.set_num_threads(2)
from benchmark.harness import core
from benchmark.tests import cells
assert core.ROOT == pathlib.Path.cwd().resolve(), core.ROOT
w = sys.argv[1]
cells.check_resolves(core, w)
cells.check_counts(core, w)
cells.check_control(core, w, "cpu")
faults = [f for c, f in cells.faults(core, full_size=False) if c == w]
core.cell_spec = cells.shrunk(core, core.cell_spec)
cells.check_sound_run(core, w)
for f in faults:
    cells.check_fault(core, w, f)
print(json.dumps({"faults": faults, "forbidden": core.forbidden_loaded()}))
"""


def _digests(root) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _copy_with_toy(tmp_path, leave_out=()) -> dict:
    """The benchmark and BENCHMARK.json copied to ``tmp_path``, the toy kind's
    files added (all new) and its entries appended to BENCHMARK.json; the
    digests of the copy's files before the toy came."""
    shutil.copytree(core.BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)
    for src in sorted(TOY.rglob("*")):
        rel = src.relative_to(TOY).as_posix()
        if src.is_dir() or "__pycache__" in src.parts or rel == "manifest.json" or rel in leave_out:
            continue
        assert rel not in before, f"the toy kind would change {rel}"
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, tmp_path / rel)
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for part, entries in json.loads((TOY / "manifest.json").read_text()).items():
        man[part] += entries
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return before


def _run(cmd, cwd, timeout=600) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH")}
    # the copy first (the working directory), then the repository: the program and chip_smoke.py
    env.update(PYTHONDONTWRITEBYTECODE="1", PYTHONPATH=str(ROOT))
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, env=env, timeout=timeout)


def test_every_kind_has_a_support_file():
    """Each cell's traffic kind has its support file, benchmark/tests/kinds/<kind>.py."""
    man = core.manifest()
    specs = [core.cell_spec(man, w) for w in cells.names(core)]
    missing = sorted({str(cells.support_path(core, s).relative_to(core.ROOT))
                      for s in specs if not cells.has_support(core, s)})
    assert not missing, "no support file: " + ", ".join(missing)


def test_kind_added_as_files(tmp_path):
    """In the copy, the toy cell resolves, its count equals the original, a
    sound run is correct, its fault is not, its control reads above a limit,
    and the process holds no JAX; the copy's own test files collect it and
    pass; no file that was there before changed but BENCHMARK.json, which
    only gained entries."""
    before = _copy_with_toy(tmp_path)
    r = _run([sys.executable, "-c", _TOY_CHECKS, TOY_CELL], tmp_path)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out == {"faults": ["state_unchanged"], "forbidden": []}, out
    r = _run(PYTEST + ["-k", TOY_CELL], tmp_path)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    summary = r.stdout.strip().splitlines()[-1]
    assert "passed" in summary and "failed" not in summary and "error" not in summary, summary
    after = _digests(tmp_path)
    changed = sorted(p for p in before if after.get(p) != before[p])
    assert changed == ["BENCHMARK.json"], changed
    old = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = json.loads((tmp_path / "BENCHMARK.json").read_text())
    assert all(new[k] == v if not isinstance(v, list) else new[k][: len(v)] == v
               for k, v in old.items())


def test_kind_without_support_file(tmp_path):
    """The toy kind without its support file: every test file still
    collects, and one test fails, naming the missing file."""
    _copy_with_toy(tmp_path, leave_out={TOY_SUPPORT})
    r = _run(PYTEST + ["-k", f"{TOY_CELL} or test_every_kind_has_a_support_file", "-rf"], tmp_path)
    summary = r.stdout.strip().splitlines()[-1]
    assert r.returncode == 1 and "1 failed" in summary and "error" not in summary, r.stdout[-3000:]
    failed = [line for line in r.stdout.splitlines() if line.startswith("FAILED")]
    assert len(failed) == 1 and "test_every_kind_has_a_support_file" in failed[0], failed
    assert TOY_SUPPORT in r.stdout
