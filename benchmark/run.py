#!/usr/bin/env python3
"""Run one cell of the benchmark of ``vae_equalizer_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for. The last line of standard output is the run's JSON result; the numbers
that decided ``correct`` are the last lines of standard error. See
``benchmark/harness/core.py``.
"""

import time

_T0 = time.perf_counter()  # set-up starts here: imports, build, inputs, warm-up

import pathlib  # noqa: E402
import sys  # noqa: E402

_ROOT = pathlib.Path(__file__).resolve().parent.parent
# the checkout's root, not this folder, resolves imports: the package
# ``benchmark`` and the program beside it
sys.path[0] = str(_ROOT)

from benchmark.harness import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(sys.argv[1:], _T0))
