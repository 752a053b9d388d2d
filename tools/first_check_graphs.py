"""First check of CUDA-graph replay on the card: build the kernels, then
chip_smoke.py's phase 31 alone (the flagship compiled and chunked against
its loop mode, the other modes compiled against theirs, ``timings`` on the
G and H experiments, ``eval_run_dp --compiled`` / ``--frames-per-call 4``).

    PYTHONPATH=. python tools/first_check_graphs.py

About 1 minute of command on the card; exits non-zero if a phase fails (a
capture that fails raises: nothing falls back to the loop mode).
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

import chip_smoke
from vae_equalizer_tpu_torch.ops import _build


def main() -> int:
    if not torch.cuda.is_available():
        print("first_check_graphs: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _, build_s, _ = _build.build()
    _build.load()
    chip_smoke._line("build", seconds=f"{build_s:.1f}", torch=torch.__version__)
    chip_smoke._graph_phases(card)
    print(f"{card} total_s={time.perf_counter() - t0:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
