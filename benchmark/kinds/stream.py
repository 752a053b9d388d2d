"""Traffic kind ``stream``: the streaming DP receiver
(``models/streaming.py: StreamingReceiver``, adapting every block) over one
continuous DP stream, block after block.

The mix's parameters: ``block_len`` (symbols a block), ``adapt_batch``
(symbols a minibatch of the block's adaptation), ``stream_blocks`` (blocks
synthesized; the window ends early, and says so, if it uses them all),
``segment_blocks`` (blocks synthesized a pass), ``check_blocks`` and
``check_span`` (how many blocks the output check follows, drawn from the
seed among the first ``check_span``), ``trace_blocks`` (blocks a traced run
profiles after the window).

Set-up synthesizes the stream on the card from the seed: PCS levels for the
whole stream, then the configuration's channel (RRC, CD, PMD, the rotation
at the configuration's theta, AWGN at its SNR) pass by pass; each pass
filters the levels of its own symbols plus the filter's span, so the passes
join into one continuous stream. The blocks are stored contiguous, one
after another, as an ADC would hand them over. Two spare blocks past the
stream warm the receiver's shapes. The window is a closed loop: a block
goes in when the previous one has come out, because one receiver adapts
block after block. A block's latency is the host clock from its hand-over
to ``step`` until its output is ready on the card. A traced run profiles
``trace_blocks`` more blocks once the window has closed.

The check follows block 0 from the Dirac start with the plain reference,
and each sampled later block from the receiver's own state before it (the
taps, Adam's moments and step, the tail), since ~150 dependent Adam steps
part two correct roundings: the state the block hands on (the change of
the taps and of Adam's moments, the step count, the tail) and the block's
output (out, q) against the reference's.
"""

from __future__ import annotations

import contextlib
import math
import sys
import time

import numpy as np
import torch

from benchmark.reference import dp_vae as ref


def synthesize(cfg: dict, mix: dict, seed: int, device: str) -> torch.Tensor:
    """The stream's blocks (stream_blocks + 2, 2, 2, sps x block_len) on ``device``."""
    bl, n_seg = mix["block_len"], mix["segment_blocks"]
    n_blocks = mix["stream_blocks"] + 2
    n_pass = -(-n_blocks // n_seg)
    N = n_seg * bl
    st = ref.Setup(cfg, N, device)
    gen = torch.Generator(device=st.device)
    gen.manual_seed(seed % 2**63)
    sps = cfg["sps"]
    lv = st.levels(torch.rand((4, n_pass * N + st.n_conv - N), generator=gen, device=st.device))
    out = torch.empty((n_pass * n_seg, 2, 2, sps * bl), dtype=torch.float32, device=st.device)
    sigma = None
    for p in range(n_pass):
        sig = st.clean(st.theta(0), lv[None, :, p * N : p * N + st.n_conv])
        if sigma is None:  # the first pass sets the noise level for the stream
            sigma = st.sigma(sig)
        rx = sig[0, ..., : sps * N] + sigma[0] * torch.randn(
            (2, 2, sps * N), generator=gen, device=st.device)
        out[p * n_seg : (p + 1) * n_seg] = rx.reshape(2, 2, n_seg, sps * bl).permute(2, 0, 1, 3)
    return out[:n_blocks]


def ref_state(state: dict) -> dict:
    """The receiver's state as the reference's flat dict."""
    return {**state["params"], **{k: state["opt"][k] for k in ("mw", "vw", "mh", "vh")},
            "step": int(state["opt"]["step"]), "tail": state["tail"]}


def _rel_change(before: dict, after: dict, r_after: dict, keys) -> float:
    """The change of ``keys`` over the block against the reference's change,
    relative to its largest entry."""
    d_got = torch.cat([(after[k] - before[k]).flatten() for k in keys])
    d_want = torch.cat([(r_after[k] - before[k]).flatten() for k in keys])
    return float((d_got - d_want).abs().max() / d_want.abs().max())


def block_gaps(before: dict, after: dict, q, out, want) -> dict:
    """One block's numbers: the state the receiver carries to the next block
    against the reference's from the same state before it (the taps' change,
    w and h together; Adam's moments' change, the worst of the four, each
    relative as the taps are; the step count and the tail, exactly); out
    relative to its largest magnitude; q absolute."""
    r_after, r_q, r_out = want
    return {"adapt_rel": _rel_change(before, after, r_after, ("w", "h")),
            "moments_rel": max(_rel_change(before, after, r_after, (k,))
                               for k in ("mw", "vw", "mh", "vh")),
            "step_abs": float(abs(after["step"] - r_after["step"])),
            "tail_abs": float((after["tail"] - r_after["tail"]).abs().max()),
            "out_rel": float((out - r_out).abs().max() / r_out.abs().max()),
            "q_abs": float((q - r_q).abs().max())}


class Cell:
    def __init__(self, cfg: dict, mix: dict, limits: dict, seed: int, device: str):
        self.cfg, self.mix, self.limits, self.seed, self.device = cfg, mix, limits, seed, device
        self.kept: dict = {}  # block -> (state before, state after, q, out)

    def setup(self) -> None:
        from vae_equalizer_tpu_torch.models.streaming import StreamingReceiver

        c, m = self.cfg, self.mix
        self.st = ref.Setup(c, m["block_len"], self.device)
        self.rxr = StreamingReceiver(self.st.amps, self.st.P, self.st.var, self.st.nu_sc,
                                     m_est=c["m_est"], sps=c["sps"], block_len=m["block_len"],
                                     lr=c["lr"], adapt=True, adapt_batch=m["adapt_batch"],
                                     use_pallas=True, device=self.device)
        t = time.perf_counter()
        self.blocks = synthesize(c, m, self.seed, self.device)
        self._sync()
        t1 = time.perf_counter()
        state = self.rxr.init()  # warm-up on the two spare blocks
        for b in (-2, -1):
            state, _, _ = self.rxr.step(state, self.blocks[b])
        self._sync()
        print(f"setup: stream synthesis {t1 - t:.3f} s, warm-up (kernels loaded or built) "
              f"{time.perf_counter() - t1:.3f} s", file=sys.stderr)

    def _sync(self) -> None:
        if self.device == "cuda":
            torch.cuda.synchronize()

    def _block(self, state: dict, blk: torch.Tensor, ev, span):
        """One block through the receiver: (state, q, out, latency in ms, end time)."""
        t = time.perf_counter()
        with span("bench.block"):
            if ev:
                ev[0].record()
            new, q, out = self.rxr.step(state, blk)
            if ev:
                ev[1].record()
                ev[1].synchronize()
        t2 = time.perf_counter()
        return new, q, out, ev[0].elapsed_time(ev[1]) if ev else 1e3 * (t2 - t), t2

    def window(self, seconds: float, tracer) -> dict:
        m = self.mix
        rng = np.random.default_rng([self.seed % 2**64, 11])
        sample = {0, *rng.choice(np.arange(1, m["check_span"]), size=m["check_blocks"],
                                 replace=False).tolist()}
        lat, state, n_win = [], self.rxr.init(), m["stream_blocks"]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if self.device == "cuda" else None
        untraced = lambda _: contextlib.nullcontext()
        tracer.rest_begin()
        t0 = time.perf_counter()
        for b in range(n_win):
            new, q, out, ms, t2 = self._block(state, self.blocks[b], ev, untraced)
            lat.append(ms)
            if b in sample:
                self.kept[b] = (state, new, q, out)
            state = new
            if t2 - t0 >= seconds:
                break
        else:
            print(f"stream: all {n_win} blocks used before {seconds} s", file=sys.stderr)
        tracer.rest_end()
        wall = time.perf_counter() - t0
        n = len(lat)
        print(f"window: {n} blocks in {wall:.3f} s, latency {np.percentile(lat, 50):.4f} / "
              f"{np.percentile(lat, 99):.4f} / {max(lat):.4f} ms (median / p99 / max)", file=sys.stderr)
        traced = m["trace_blocks"] if tracer.on else 0
        if traced:  # the blocks after the window (from the stream's start once it is used up)
            tracer.start()
            for i in range(traced):
                blk = self.blocks[(n + i) % n_win]
                state = self._block(state, blk, ev, torch.profiler.record_function)[0]
            tracer.stop(units=traced)
        return {"attempted": n + traced, "failed": 0,
                "metrics": {"symbols_per_s": n * m["block_len"] / wall,
                            "block_ms_p99": float(np.percentile(np.asarray(lat), 99))}}

    def check(self) -> list[dict]:
        """The numbers of the kept blocks; a number none of them reads (the
        window ended before every sampled block past block 0) is left out."""
        got = self.readings()
        return [{"name": name, "value": got[name], "limit": limit}
                for name, limit in self.limits["limits"].items() if name in got]

    def readings(self) -> dict:
        """Block 0 from the reference's own start, each later kept block from
        the receiver's state before it; the worst of each number."""
        out: dict = {}
        with torch.no_grad():
            for b, (before, after, q, o) in sorted(self.kept.items()):
                rs = ref_state(before)
                if b == 0:  # the reference's own Dirac start, zero moments, zero tail
                    init = ref.dirac(self.cfg["m_est"], 1, self.blocks.device)
                    rs = {k: v[0] for k, v in {**init, **ref.zero_moments(init)}.items()}
                    rs.update(step=0, tail=torch.zeros_like(before["tail"]))
                want = ref.stream_block(self.st, rs, self.blocks[b], self.mix["adapt_batch"])
                g = block_gaps(rs, ref_state(after), q, o, want)
                for k, v in g.items():
                    key = f"block0_{k}" if b == 0 else k
                    v = v if math.isfinite(v) else math.inf
                    out[key] = max(out.get(key, 0.0), v)
        return out
