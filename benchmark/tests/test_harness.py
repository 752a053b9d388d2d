"""Whole runs on the CPU at a small size, past the harness's look for a
card: a sound run comes out correct, and each fault the cells can have,
planted under the timed path, comes out not correct against the cells'
limits."""

import argparse
import time

import pytest

from benchmark.harness import core as _core
from benchmark.tests import control

CELLS = [w["name"] for w in _core.manifest()["workloads"]]
# the final butterflies' SER needs the whole experiment to converge, which
# the small size does not reach; every other number keeps the cell's limit
UNCONVERGED = ("final_ser",)
# a carry dropped between frames shows only in the final butterflies' SER:
# test_control.py reads that fault in an experiment cell at full size on a card
FAULT_CASES = [(w, f) for w in CELLS for f in control.FAULTS
               if not (f == "carry_dropped" and _core.cell_spec(_core.manifest(), w)["mix"]["kind"]
                       == "experiment")]


def _run(core, workload: str, seed: int) -> dict:
    # a stream's window runs to the end of its 24 blocks, so every sampled block is checked
    seconds = 600.0 if "stream" in workload else 0.5
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=0)
    return core.run(args, time.perf_counter(), device="cpu")


@pytest.fixture
def small(small_cells, monkeypatch):
    resolve = small_cells.cell_spec

    def spec(man, w):
        s = resolve(man, w)
        s["limits"] = {"limits": {k: v for k, v in s["limits"]["limits"].items()
                                  if k not in UNCONVERGED}}
        return s
    monkeypatch.setattr(small_cells, "cell_spec", spec)
    return small_cells


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(small, workload):
    res = _run(small, workload, 2**31 + 5)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] >= 1 and res["failed"] == 0
    assert "setup_s" in res["metrics"] and "symbols_per_s" in res["metrics"]


@pytest.mark.parametrize("workload,fault", FAULT_CASES)
def test_fault_is_not_correct(small, workload, fault):
    with control.fault(fault):
        res = _run(small, workload, 2**31 + 6)
    assert not res["correct"], res["checks"]
