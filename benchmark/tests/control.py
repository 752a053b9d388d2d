"""The output check's control and its faults, run on the card at a cell's
own size from the command line:

    python -m benchmark.tests.control --workload <cell> --seeds 1,2,3 [--mode MODE]

prints one JSON line per seed with the numbers the check compares: the
control's (the default), or those of a whole run (``--seconds``), sound
(``--mode sound``) or under a fault (``--mode state_unchanged`` ...).

What the control and the faults are for a cell comes from the support file
of its traffic kind, ``benchmark/tests/kinds/<kind>.py``
(``benchmark/tests/cells.py`` lists what one holds): the control is the
plain reference put in the program's place and computed one precision
below the configuration's, and a fault breaks the program's timed path
underneath a run. The modes are ``sound``, ``control``, and the kind's
faults: its ``FAULTS`` and any other that its ``fault`` plants (the
experiments' ``optimizer_restarted``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from benchmark.harness import core
from benchmark.tests import cells


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", default="control",
                   help="sound, control (the default), or a fault of the cell's kind")
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    spec = core.cell_spec(core.manifest(), a.workload)
    if not cells.has_support(core, spec):
        print(f"control: no support file {cells.support_path(core, spec)}", file=sys.stderr)
        return 2
    sup = cells.support(core, spec)
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        if a.mode == "control":
            out = sup.control(core.cell_spec(core.manifest(), a.workload), seed, device, a.seconds)
        else:
            args = argparse.Namespace(workload=a.workload, seed=seed, seconds=a.seconds, trace=0)
            with sup.fault(a.mode) if a.mode != "sound" else contextlib.nullcontext():
                res = core.run(args, time.perf_counter(), device)
            out = {k: v["value"] for k, v in res["checks"].items()}
            out.update(correct=res["correct"], attempted=res["attempted"])
        print(json.dumps({"workload": a.workload, "seed": seed, "mode": a.mode,
                          "seconds": round(time.perf_counter() - t, 1), **out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
