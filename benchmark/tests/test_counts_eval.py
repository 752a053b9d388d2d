"""Kernel K's frozen count in the experiment cells (``counts_eval.py``)
against ``chip_smoke.py``'s at the 128-run cell's shapes, as the sweep
kind's support file holds the sweep's: its operations to
``chip_smoke._eval_flops``, its bytes to ``chip_smoke._nbytes`` of kernel
B's streams, tx and K's results, and bound by its bytes."""

import pytest

from benchmark.harness import core, counts, counts_eval
from benchmark.tests.kinds import sweep


@pytest.mark.parametrize("workload", ["dp_vae.replay.r128"])
def test_k_count_equals_chip_smoke(workload):
    import chip_smoke

    spec = core.cell_spec(core.manifest(), workload)
    k = counts_eval.k_experiment(spec["config"], spec["mix"])
    assert k["runs"] == spec["mix"]["runs"] == 128
    _, plain = sweep._plain_b(counts.b_experiment(spec["config"], spec["mix"]))
    kernel, frozen, original, bound_by = sweep._kernel_k(k, plain[5:10])
    assert frozen == original, (kernel, frozen, original)
    b = chip_smoke._bound(*frozen)
    assert counts.bound(*frozen) == {key: b[key] for key in ("bound_ms", "bound_by")}
    assert b["bound_by"] == bound_by
