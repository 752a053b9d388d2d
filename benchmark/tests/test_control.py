"""The control on the card: the plain reference in the program's place one
precision below the configuration's (TF32 matrix products for the DP
kinds' float32), at a cell's own widths, comes out not correct against
the cell's limits; and each fault that only a run at the cell's own size
shows (the experiments' dropped carry) comes out not correct there."""

import pytest

from benchmark.harness import core
from benchmark.tests import cells

CELLS = cells.names(core)
FULL_SIZE = cells.faults(core, full_size=True)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_check(cuda, workload):
    cells.check_control(core, workload, "cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", [w for w in CELLS if w in dict(FULL_SIZE)])
def test_carry_dropped_fails_at_full_size(cuda, workload):
    """Each of the cell's full-size faults in a whole run at the cell's size
    (kernel B from zero moments at step 0 every frame: the check holds the
    final butterflies' SER)."""
    for w, fault in FULL_SIZE:
        if w == workload:
            cells.check_full_size_fault(core, workload, fault, "cuda")
