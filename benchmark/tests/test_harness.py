"""Whole runs on the CPU at each kind's small size, past the harness's look
for a card: a sound run comes out correct, and each fault the cell's kind
plants under the timed path comes out not correct against the cell's
limits (a fault that only a run at the cell's own size shows is
``test_control.py``'s)."""

import pytest

from benchmark.harness import core as _core
from benchmark.tests import cells


@pytest.mark.parametrize("workload", cells.names(_core))
def test_sound_run_is_correct(small_cells, workload):
    cells.check_sound_run(small_cells, workload)


@pytest.mark.parametrize("workload,fault", cells.faults(_core, full_size=False))
def test_fault_is_not_correct(small_cells, workload, fault):
    cells.check_fault(small_cells, workload, fault)
