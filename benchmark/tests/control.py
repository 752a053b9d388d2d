"""The output check's control and its faults, for the tests and for a run on
the card at a cell's own size.

* The control is the plain reference put in the program's place and
  computed one precision below the configuration's float32 with TF32 off:
  with TF32 matrix products (``reference.dp_vae.precision("tf32")``). An
  experiment cell's control trains and evaluates frame 0 of every run in
  TF32; a stream cell's control adapts and outputs each block the check
  follows in TF32, from the same state before it as the check's reference.
  The check's numbers are then read off the control's outputs as off the
  program's.
* A fault breaks the program's timed path underneath a run (``FAULTS``): a
  training step that returns its state unchanged (kernel B at lr 0, its
  moments given back); half of the batch left out (half of the runs of a
  kernel B launch left untrained, or a block's second half of
  minibatches); an answer altered where it is produced (each frame's soft
  SER raised by 0.01, or a block's equalized output scaled by 1 + 1e-3);
  the carry dropped between frames or blocks (every frame's kernel B launch
  starts from the Dirac taps with zero Adam moments at step 0; a block
  hands on its new taps with the moments, step count and tail it was
  given). These one-card cells have no exchange between cards to leave
  out. ``optimizer_restarted``, not among ``FAULTS``, drops only a frame's
  Adam moments and step count: restarted Adam converges as well, and no
  number of the check reads it (PERF.md).

    python -m benchmark.tests.control --workload <cell> --seeds 1,2,3 [--mode MODE]

prints one JSON line per seed with the numbers the check compares: the
control's (the default), or those of a whole run (``--seconds``), sound
(``--mode sound``) or under a fault (``--mode state_unchanged`` ...).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from benchmark.harness import core
from benchmark.reference import dp_vae as ref


def experiment_control(spec: dict, seed: int, device: str) -> dict:
    """An experiment cell's numbers with the TF32 reference in the program's
    place: frame 0 of experiment 1 of ``seed``."""
    kind = spec["kind"]
    s = kind.experiment_seed(seed, 1)
    got = ref.frame0(spec["config"], s, spec["mix"]["runs"], device, "tf32")
    want = ref.frame0(spec["config"], s, spec["mix"]["runs"], device, "float32")
    return kind.gaps(got, want)


def stream_control(spec: dict, seed: int, device: str, seconds: float = 2.0) -> dict:
    """A stream cell's numbers with the TF32 reference in the program's place
    for the blocks the check follows: the program runs the window, then each
    kept block's adaptation and output are the TF32 reference's from the
    same state before it (block 0: from the Dirac start), and the check
    reads them as it reads the program's."""
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


@contextlib.contextmanager
def _patched(module, name: str, fn):
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _frozen(b, rows=slice(None)):
    """Kernel B whose steps leave the state of runs ``rows`` unchanged: those
    runs train at lr 0 (every step's forward pass and streams from the state
    it was given) and get their Adam moments back as given."""
    def fault(w, h, opt, rx, amps, var, nu_sc, P, lr, *args, **kw):
        R = w.shape[0]
        lr_runs = torch.full((R,), float(lr), device=w.device) if not torch.is_tensor(lr) \
            else lr.expand(R).clone()
        lr_runs[rows] = 0.0
        w2, h2, o2, *rest = b(w, h, opt, rx, amps, var, nu_sc, P, lr_runs, *args, **kw)
        o2 = {k: v.clone() for k, v in o2.items()}
        for k in o2:
            o2[k][rows] = opt[k][rows]
        return (w2, h2, o2, *rest)
    return fault


def _b_half_block(b):
    """Kernel B on the first half of a block's minibatches only (R = 1: the stream)."""
    def fault(w, h, opt, rx, *args, **kw):
        return b(w, h, opt, rx[..., : rx.shape[-1] // 2].contiguous(), *args, **kw)
    return fault


def _b_fresh_start(b, params: bool):
    """Kernel B from zero Adam moments at step 0 whatever it is given, and
    with ``params`` from the Dirac start too (the experiments' frames)."""
    def fault(w, h, opt, rx, amps, var, nu_sc, P, lr, count, *args, **kw):
        zeros = {k: torch.zeros_like(v) for k, v in opt.items()}
        if params:
            start = ref.dirac(w.shape[-1], w.shape[0], w.device)
            w, h = start["w"], start["h"]
        return b(w, h, zeros, rx, amps, var, nu_sc, P, lr, torch.zeros_like(count), *args, **kw)
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
    """Break the program's timed path for the block's duration."""
    from vae_equalizer_tpu_torch.models import streaming
    from vae_equalizer_tpu_torch.train import dp

    with contextlib.ExitStack() as stack:
        if name == "state_unchanged":
            stack.enter_context(_patched(dp, "vae_dp_frame_train", _frozen(dp.vae_dp_frame_train)))
            stack.enter_context(_patched(streaming, "vae_dp_frame_train",
                                         _frozen(streaming.vae_dp_frame_train)))
        elif name == "half_batch":
            half = lambda b: lambda w, *a, **k: _frozen(b, slice(w.shape[0] // 2, None))(w, *a, **k)
            stack.enter_context(_patched(dp, "vae_dp_frame_train", half(dp.vae_dp_frame_train)))
            stack.enter_context(_patched(streaming, "vae_dp_frame_train",
                                         _b_half_block(streaming.vae_dp_frame_train)))
        elif name == "answer_altered":
            metrics = dp._vae_metrics

            def altered(losses, ser_const, ser_soft, *rest):  # one symbol in a hundred more errors
                return metrics(losses, ser_const, ser_soft + 1e-2, *rest)
            stack.enter_context(_patched(dp, "_vae_metrics", altered))
            fused = streaming.vae_le_dp_forward_fused

            def fused_altered(*args, **kw):
                q, out = fused(*args, **kw)
                return q, out * (1 + 1e-3)
            stack.enter_context(_patched(streaming, "vae_le_dp_forward_fused", fused_altered))
        elif name in ("carry_dropped", "optimizer_restarted"):
            stack.enter_context(_patched(dp, "vae_dp_frame_train", _b_fresh_start(
                dp.vae_dp_frame_train, params=name == "carry_dropped")))
            rx = streaming.StreamingReceiver
            stack.enter_context(_patched(rx, "step", _step_keeps_carry(rx.step)))
        else:
            raise ValueError(f"unknown fault {name!r}")
        yield


FAULTS = ("state_unchanged", "half_batch", "answer_altered", "carry_dropped")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", default="control",
                   choices=("sound", "control") + FAULTS + ("optimizer_restarted",),
                   help="a sound run, the TF32 control, or a run under a fault")
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        if a.mode == "control":
            spec = core.cell_spec(core.manifest(), a.workload)
            if spec["mix"]["kind"] == "stream":
                out = stream_control(spec, seed, device, a.seconds)
            else:
                out = experiment_control(spec, seed, device)
        else:
            args = argparse.Namespace(workload=a.workload, seed=seed, seconds=a.seconds, trace=0)
            with fault(a.mode) if a.mode != "sound" else contextlib.nullcontext():
                res = core.run(args, time.perf_counter(), device)
            out = {k: v["value"] for k, v in res["checks"].items()}
            out.update(correct=res["correct"], attempted=res["attempted"])
        print(json.dumps({"workload": a.workload, "seed": seed, "mode": a.mode,
                          "seconds": round(time.perf_counter() - t, 1), **out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
