"""Mean host length of the program's ``sweep.record`` span: one grid point's record in
the sweep engine (``parallel/sweep.py: run_sweep``), its share of the call's result, the
JSONL append and its parameter file (``spans.mean_host_ms``)."""

from benchmark.harness import spans


def read(t, cell):
    return spans.mean_host_ms(t, "sweep.record")
