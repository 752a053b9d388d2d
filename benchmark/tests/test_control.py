"""The control on the card: the plain reference in the program's place with
TF32 matrix products, one precision below the configurations' float32, at a
cell's own widths, comes out not correct against each cell's limits; and a
fault that only a converged experiment shows, read at the cell's own size."""

import pytest

from benchmark.harness import core
from benchmark.tests import control

CELLS = [w["name"] for w in core.manifest()["workloads"]]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_check(cuda, workload):
    spec = core.cell_spec(core.manifest(), workload)
    if spec["mix"]["kind"] == "stream":  # a short stream: the check's blocks among the first 64
        spec["mix"].update(stream_blocks=64, segment_blocks=32, check_span=64)
        readings = control.stream_control(spec, 2**31 + 17, "cuda", seconds=1.0)
    else:
        readings = control.experiment_control(spec, 2**31 + 17, "cuda")
    limits = spec["limits"]["limits"]
    assert any(v > limits[k] for k, v in readings.items()), readings


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", [w for w in CELLS if "stream" not in w])
def test_carry_dropped_fails_at_full_size(cuda, workload):
    """Kernel B from zero moments at step 0 every frame: a whole run at the
    cell's size, whose final butterflies' SER the check holds."""
    import argparse
    import time

    args = argparse.Namespace(workload=workload, seed=2**31 + 19, seconds=1.0, trace=0)
    with control.fault("carry_dropped"):
        res = core.run(args, time.perf_counter(), "cuda")
    assert not res["correct"], res["checks"]
