"""Grid sweeps over the runners (``sweep.py``). The JAX package's mesh and
sequence-parallel plumbing is not here: the port's runs are a tensor axis
of one launch (``train/batching.py`` has no counterpart), and sequence
parallelism waits (ROADMAP.md, queue 1: 'Sequence parallelism')."""

from .sweep import RUNNERS, assemble_mat, expand_grid, point_seed, run_sweep

__all__ = ["RUNNERS", "assemble_mat", "expand_grid", "point_seed", "run_sweep"]
