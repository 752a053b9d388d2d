"""The benchmark's own tests (``python -m pytest benchmark/tests -q`` from the
checkout's root): the repository's root on the import path, the cells shrunk
to the sizes a CPU holds that their kinds' support files give
(``benchmark/tests/kinds/<kind>.py``), and the card looked for inside the
tests that need it."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def small_cells(monkeypatch):
    """Every cell the harness resolves comes out shrunk; returns the harness."""
    import torch

    from benchmark.harness import core
    from benchmark.tests import cells

    torch.set_num_threads(min(4, torch.get_num_threads()))
    monkeypatch.setattr(core, "cell_spec", cells.shrunk(core, core.cell_spec))
    return core


@pytest.fixture
def cuda():
    """The card, or a skip: decided inside the test, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
