"""What the benchmark's tests know of traffic kind ``stream``
(``benchmark/kinds/stream.py``): the streaming DP receiver block after
block, kernel B at R = 1 and kernel E a block (``benchmark/tests/cells.py``
lists the names a support file holds).

* The control: the program runs the window, then each block the check
  follows is adapted and output by the plain reference in TF32
  (``reference.dp_vae.precision("tf32")``), one precision below the
  configuration's float32 with TF32 off, from the same state before it as
  the check's reference (block 0: from the Dirac start), and the check
  reads it as it reads the program's.
* The faults (``FAULTS``), planted in ``models/streaming.py``: kernel B
  returning the state it was given (lr 0, its Adam moments given back); a
  block's second half of minibatches left out; each block's equalized
  output scaled by 1 + 1e-3; the carry dropped (a block hands on its new
  taps with the moments, step count and tail it was given). Each shows at
  the CPU's size.
"""

from __future__ import annotations

import contextlib

from benchmark.harness import counts
from benchmark.reference import dp_vae as ref
from benchmark.tests.cells import patched
from benchmark.tests.kinds.experiment import b_frozen, kernel_b

# a stream of 24 blocks, 3 of the first 16 checked besides block 0
SMALL_MIX = {"stream_blocks": 24, "segment_blocks": 8, "check_span": 16, "check_blocks": 3,
             "trace_blocks": 8}
# the window runs to the end of the shrunk stream, so every sampled block is checked
CPU_SECONDS = 600.0
FAULTS = ("state_unchanged", "half_batch", "answer_altered", "carry_dropped")
FULL_SIZE_ONLY = ()


def shrink(spec: dict) -> dict:
    spec["mix"].update(SMALL_MIX)
    return spec


def launches(spec: dict) -> list[tuple]:
    return [kernel_b(counts.b_stream(spec["config"], spec["mix"]))]


def control(spec: dict, seed: int, device: str, seconds: float = 2.0) -> dict:
    """The numbers with the TF32 reference in the program's place for the
    blocks the check follows: the program runs the window, then each kept
    block's adaptation and output are the TF32 reference's from the same
    state before it (block 0: from the Dirac start), and the check reads
    them as it reads the program's."""
    from benchmark.harness import trace

    kind = spec["kind"]
    cell = kind.Cell(spec["config"], spec["mix"], spec["limits"], seed, device)
    cell.setup()
    cell.window(seconds, trace.Tracer(False, device))
    as_state = lambda f: {"params": {"w": f["w"], "h": f["h"]}, "tail": f["tail"],
                          "opt": {**{k: f[k] for k in ("mw", "vw", "mh", "vh")}, "step": f["step"]}}
    for b, (before, _, _, _) in list(cell.kept.items()):
        new, q, out = ref.stream_block(cell.st, kind.ref_state(before), cell.blocks[b],
                                       spec["mix"]["adapt_batch"], "tf32")
        cell.kept[b] = (before, as_state(new), q, out)
    return cell.readings()


def tested_control(spec: dict, seed: int, device: str) -> dict:
    """A short stream: the check's blocks among the first 64, at full width."""
    spec["mix"].update(stream_blocks=64, segment_blocks=32, check_span=64)
    return control(spec, seed, device, seconds=1.0)


def _b_half_block(b):
    """Kernel B on the first half of a block's minibatches only (R = 1)."""
    def fault(w, h, opt, rx, *args, **kw):
        return b(w, h, opt, rx[..., : rx.shape[-1] // 2].contiguous(), *args, **kw)
    return fault


def _step_keeps_carry(step):
    """A receiver's block that hands on its new taps but the moments, step
    count and tail it was given."""
    def fault(self, state, block):
        new, q, out = step(self, state, block)
        return {**new, "opt": state["opt"], "tail": state["tail"]}, q, out
    return fault


@contextlib.contextmanager
def fault(name: str):
    """Break the stream's timed path for the block's duration."""
    from vae_equalizer_tpu_torch.models import streaming

    if name == "state_unchanged":
        plant = patched(streaming, "vae_dp_frame_train", b_frozen(streaming.vae_dp_frame_train))
    elif name == "half_batch":
        plant = patched(streaming, "vae_dp_frame_train", _b_half_block(streaming.vae_dp_frame_train))
    elif name == "answer_altered":
        fused = streaming.vae_le_dp_forward_fused

        def fused_altered(*args, **kw):
            q, out = fused(*args, **kw)
            return q, out * (1 + 1e-3)
        plant = patched(streaming, "vae_le_dp_forward_fused", fused_altered)
    elif name == "carry_dropped":
        rx = streaming.StreamingReceiver
        plant = patched(rx, "step", _step_keeps_carry(rx.step))
    else:
        raise ValueError(f"unknown fault {name!r} of kind stream")
    with plant:
        yield
