"""The benchmark's own tests (``python -m pytest benchmark/tests -q`` from the
checkout's root): the repository's root on the import path, the cells shrunk
to sizes a CPU holds, and the card looked for inside the tests that need it."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a cell at a size the CPU runs in seconds: 2 frames of 2,000 symbols (20
# minibatch steps a frame), a stream of 24 blocks
SMALL_CONFIG = {"num_frames": 2, "n_frame_max": 2000}
SMALL_MIX = {"stream_blocks": 24, "segment_blocks": 8, "check_span": 16, "check_blocks": 3,
             "trace_blocks": 8}


def shrink(spec: dict) -> dict:
    spec["config"].update(SMALL_CONFIG)
    spec["mix"].update(SMALL_MIX)
    return spec


@pytest.fixture
def small_cells(monkeypatch):
    """Every cell the harness resolves comes out shrunk; returns the harness."""
    import torch

    from benchmark.harness import core

    torch.set_num_threads(min(4, torch.get_num_threads()))
    resolve = core.cell_spec
    monkeypatch.setattr(core, "cell_spec", lambda man, w: shrink(resolve(man, w)))
    return core


@pytest.fixture
def cuda():
    """The card, or a skip: decided inside the test, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
