"""Nothing the benchmark runs loads JAX or the JAX package (top-level names
compared whole), and a checkout without the program prints no result."""

import os
import shutil
import subprocess
import sys
import types

from benchmark.harness import core

from .conftest import ROOT

_RUN_ALL_KINDS = """
import sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(2)
from benchmark.harness import core
from benchmark.tests import cells
man = core.manifest()
runnable = [w for w in sorted(cells.names(core)) if cells.has_support(core, core.cell_spec(man, w))]
core.cell_spec = cells.shrunk(core, core.cell_spec)
for w in runnable:
    cells.run(core, w, seed=3, seconds=1.0)
print(core.forbidden_loaded())
sys.exit(1 if core.forbidden_loaded() else 0)
"""


def test_whole_names_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "vae_equalizer_tpu_torch_extra", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert core.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "vae_equalizer_tpu.sub", types.ModuleType("x"))
    assert "vae_equalizer_tpu" in core.forbidden_loaded()


def test_runs_load_no_jax():
    """A run of every cell whose kind has a support file (at its small size
    on the CPU) in a fresh process leaves no JAX, jaxlib, flax or JAX
    package module behind."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH")}
    r = subprocess.run([sys.executable, "-c", _RUN_ALL_KINDS, str(ROOT)], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/, a run
    exits with another code than 0 and prints nothing on standard output."""
    shutil.copytree(core.BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "dp_vae.replay.r8",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == "", (r.returncode, r.stdout)
    assert "benchmark:" in r.stderr
