"""Frozen counts of the toy program's step, copied from
``toy_program.step_flops`` and ``step_bytes``."""


def step_launch(batch: int, dim: int) -> tuple[int, int]:
    """(operations, bytes) of one step of ``batch`` rows of ``dim``."""
    return 2 * batch * dim * dim + 2 * batch * dim, 4 * (3 * batch * dim + dim * dim)
