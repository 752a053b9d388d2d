"""A toy program: a state carried from call to call, each call a few steps
x <- tanh(x w + u) on a batch, in plain PyTorch on the CPU. It stands in for
the program under test where ``benchmark/tests/test_kinds.py`` adds a
traffic kind to a copy of the benchmark as new files only."""

import torch


def step(x: torch.Tensor, w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x @ w + u)


def call(x: torch.Tensor, w: torch.Tensor, us: torch.Tensor):
    """``len(us)`` steps from the state ``x``: the state handed on, and every step's output."""
    outs = []
    for u in us:
        x = step(x, w, u)
        outs.append(x)
    return x, torch.stack(outs)


def step_flops(batch: int, dim: int) -> int:
    """One step's operations: the product, the bias, the tanh as one each."""
    return 2 * batch * dim * dim + 2 * batch * dim


def step_bytes(batch: int, dim: int) -> int:
    """One step's bytes: x, w and u read once, x written once, float32."""
    return 4 * (3 * batch * dim + dim * dim)
