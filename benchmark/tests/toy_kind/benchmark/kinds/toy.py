"""Traffic kind ``toy``: calls of the toy program (``toy_program.call``),
each ``steps`` steps on a batch of ``batch`` rows, the state carried from
call to call, ``calls`` calls at most. The check holds every call's output
against the plain reference's (``benchmark/reference/toy.py``) from the
same inputs, the carried state included."""

from __future__ import annotations

import time

import torch

from benchmark.reference import toy as ref


def inputs(cfg: dict, mix: dict, seed: int):
    """The weight, every call's inputs and the start state, from the seed."""
    g = torch.Generator().manual_seed(seed % 2**63)
    d = cfg["dim"]
    w = torch.randn((d, d), generator=g) / d**0.5
    us = torch.randn((mix["calls"], mix["steps"], mix["batch"], d), generator=g)
    return w, us, torch.zeros((mix["batch"], d))


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


class Cell:
    def __init__(self, cfg: dict, mix: dict, limits: dict, seed: int, device: str):
        self.cfg, self.mix, self.limits, self.seed = cfg, mix, limits, seed
        self.outs: list = []

    def setup(self) -> None:
        import toy_program

        self.prog = toy_program
        self.w, self.us, self.x0 = inputs(self.cfg, self.mix, self.seed)
        self.prog.call(self.x0, self.w, self.us[0])

    def window(self, seconds: float, tracer) -> dict:
        x = self.x0
        tracer.rest_begin()
        t0 = time.perf_counter()
        for k in range(self.mix["calls"]):
            x, y = self.prog.call(x, self.w, self.us[k])
            self.outs.append(y)
            if time.perf_counter() - t0 >= seconds:
                break
        tracer.rest_end()
        wall = time.perf_counter() - t0
        n = len(self.outs)
        return {"attempted": n, "failed": 0,
                "metrics": {"symbols_per_s": n * self.mix["steps"] * self.mix["batch"] / wall}}

    def check(self) -> list[dict]:
        want = ref.outputs(self.x0, self.w, self.us[: len(self.outs)].flatten(0, 1))
        return [{"name": "out_rel", "value": gap(torch.cat(self.outs), want),
                 "limit": self.limits["limits"]["out_rel"]}]
