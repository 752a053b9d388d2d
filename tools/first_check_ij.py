"""First check of kernels I and J on the card: build, ptxas figures, then
chip_smoke.py's phases 25-29 alone (I against its plain version, the AWGN
CMA experiment, J against its plain version, the LMMSE / DFE sweep, the four
AWGN drivers) and the kernels' JSON entries.

    PYTHONPATH=. python tools/first_check_ij.py

About 1-2 minutes of command on the card; exits non-zero if a phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

import chip_smoke
from vae_equalizer_tpu_torch.ops import _build


def main() -> int:
    if not torch.cuda.is_available():
        print("first_check_ij: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _, build_s, log = _build.build()
    _build.load()
    lines = log.splitlines()
    keep = [i for i, ln in enumerate(lines) if "cma_siso" in ln or "dfe_decide" in ln]
    ptxas = [lines[j].strip() for i in keep for j in (i, i + 1, i + 2) if j < len(lines)]
    chip_smoke._line("build", seconds=f"{build_s:.1f}", ptxas=repr(" | ".join(ptxas)))
    entries = chip_smoke._cma_awgn_phases(card) + chip_smoke._dfe_phases(card)
    chip_smoke._drivers_phase(card)
    print(json.dumps({"kernels": entries}), flush=True)
    print(f"{card} total_s={time.perf_counter() - t0:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
