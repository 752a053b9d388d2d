"""What the benchmark's tests know of traffic kind ``toy``
(``benchmark/kinds/toy.py``). The control is the reference in bfloat16,
the step below the configuration's float32; the one fault is a step that
returns its state unchanged."""

from __future__ import annotations

import contextlib

from benchmark.harness import counts_toy
from benchmark.reference import toy as ref
from benchmark.tests.cells import patched

CPU_SECONDS = 5.0  # every call of the mix runs
FAULTS = ("state_unchanged",)
FULL_SIZE_ONLY = ()


def shrink(spec: dict) -> dict:
    return spec  # the cell is CPU-sized as it stands


def launches(spec: dict) -> list[tuple]:
    import toy_program

    b, d = spec["mix"]["batch"], spec["config"]["dim"]
    original = toy_program.step_flops(b, d), toy_program.step_bytes(b, d)
    return [("toy_step", counts_toy.step_launch(b, d), original, "bytes")]


def control(spec: dict, seed: int, device: str, seconds: float = 0.0) -> dict:
    import torch

    kind = spec["kind"]
    w, us, x0 = kind.inputs(spec["config"], spec["mix"], seed)
    us = us.flatten(0, 1)
    return {"out_rel": kind.gap(ref.outputs(x0, w, us, torch.bfloat16), ref.outputs(x0, w, us))}


def tested_control(spec: dict, seed: int, device: str) -> dict:
    return control(spec, seed, device)


@contextlib.contextmanager
def fault(name: str):
    import toy_program

    if name != "state_unchanged":
        raise ValueError(f"unknown fault {name!r} of kind toy")
    with patched(toy_program, "step", lambda x, w, u: x):
        yield
