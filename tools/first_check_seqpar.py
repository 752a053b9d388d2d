"""First check of the dp x sp sharded path on one card: two ``gloo`` ranks on
``cuda:0``.

    PYTHONPATH=. python tools/first_check_seqpar.py

Prints one line per check:

  collectives  each collective the sharded runners use, called by both ranks
               on the card's tensors as they are (all_reduce, all_gather,
               broadcast, scatter, gather): ok and right, or the error it
               raised; then the same through ``parallel/mesh.py: Comm``
  halo         ``halo_exchange`` (left 24, right 12) forward and backward
               against the zero-padded gathered array and its transpose
  step         one dp 1 x sp 2 step at the flagship's width (64-QAM, M 25,
               one 100-symbol minibatch, R 2) against the unsharded
               autograd step: loss, var_est, raw gradients (and their ratio),
               params after Adam
  dryrun       ``parallel/dryrun.py: dryrun_multichip(2)`` on cuda:0
  runner       ``train_vae_dp_sharded`` (DpConfig(), 2 frames, R 2) and
               ``train_vae_dp``: wall per frame, the share of the sharded
               training in collectives

Each rank function here is spawned by ``run_ranks`` (this file is the
spawned ranks' main module).
"""

from __future__ import annotations

import dataclasses
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist

from vae_equalizer_tpu_torch.core import demapper_noise_var, make_constellation
from vae_equalizer_tpu_torch.models import elbo_dp, vae_le_dp_forward
from vae_equalizer_tpu_torch.ops.frame_kernel import adam_update
from vae_equalizer_tpu_torch.parallel.dryrun import dryrun_multichip, halo_roundtrip
from vae_equalizer_tpu_torch.parallel.mesh import Call, make_mesh_2d, run_ranks
from vae_equalizer_tpu_torch.parallel.seqpar import make_sp_dp_train_step, sharded_call
from vae_equalizer_tpu_torch.train import train_vae_dp
from vae_equalizer_tpu_torch.utils import DpConfig


def _native(comm, op: str) -> str:
    """``op`` on the card's tensors as they are, under the group's backend."""
    dev, r, w = comm.device, comm.rank, comm.mesh.size
    x = torch.full((4,), float(r + 1), device=dev)
    try:
        if op == "all_reduce":
            dist.all_reduce(x)
            ok = bool(torch.all(x == w * (w + 1) / 2))
        elif op == "all_gather":
            parts = [torch.empty_like(x) for _ in range(w)]
            dist.all_gather(parts, x)
            ok = all(bool(torch.all(p == i + 1)) for i, p in enumerate(parts))
        elif op == "broadcast":
            dist.broadcast(x, src=0)
            ok = bool(torch.all(x == 1))
        elif op == "scatter":
            src = [torch.full((4,), 10.0 + i, device=dev) for i in range(w)] if r == 0 else None
            dist.scatter(x, src, src=0)
            ok = bool(torch.all(x == 10 + r))
        else:  # gather
            parts = [torch.empty_like(x) for _ in range(w)] if r == 0 else None
            dist.gather(x, parts, dst=0)
            ok = r != 0 or all(bool(torch.all(p == i + 1)) for i, p in enumerate(parts))
        return "ok" if ok else "WRONG"
    except (RuntimeError, ValueError) as e:
        return f"raises {type(e).__name__}: {str(e).splitlines()[0][:120]}"


def _probe(comm) -> dict:
    """Every collective on the card's tensors, then through Comm."""
    res = {op: _native(comm, op) for op in ("all_reduce", "all_gather", "broadcast", "scatter",
                                            "gather")}
    dev, r, w = comm.device, comm.rank, comm.mesh.size
    x = torch.arange(6.0, device=dev) + r
    s = comm.all_reduce_sp(x.clone())
    g = comm.all_gather_sp(x)
    chunks = [torch.full((2, 3), float(i), device=dev) for i in range(w)] if r == 0 else None
    sc = comm.scatter(chunks, (2, 3))
    ga = comm.gather(x)
    ok = (torch.equal(s, sum(torch.arange(6.0, device=dev) + i for i in range(w)))
          and all(torch.equal(p, torch.arange(6.0, device=dev) + i) for i, p in enumerate(g))
          and bool(torch.all(sc == r)) and sc.device == dev
          and (ga is None or all(torch.equal(p, torch.arange(6.0, device=dev) + i)
                                 for i, p in enumerate(ga))))
    res["comm"] = f"{'ok' if ok else 'WRONG'} (backend={comm.mesh.backend})"
    return res


def _halo_ref(x, g, n_sp, left, right):
    """Forward blocks and input gradient of the zero-padded gathered array."""
    xt = torch.from_numpy(x).requires_grad_()
    ln = x.shape[-1] // n_sp
    xp = torch.nn.functional.pad(xt, (left, right))
    outs = [xp[..., s * ln : s * ln + left + ln + right] for s in range(n_sp)]
    dot = sum((o * torch.from_numpy(g[s])).sum() for s, o in enumerate(outs))
    (gx,) = torch.autograd.grad(dot, xt)
    return torch.stack([o.detach() for o in outs]), gx


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("first_check_seqpar: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"device {card!r} torch {torch.__version__} cuda {torch.version.cuda} "
          f"count {torch.cuda.device_count()}", flush=True)
    mesh = make_mesh_2d(1, 2, devices=["cuda:0"] * 2)
    rng = np.random.default_rng(0)
    left, right, ln = 24, 12, 100
    xh = rng.normal(size=(4, 2 * ln)).astype(np.float32)
    gh = rng.normal(size=(2, 4, left + ln + right)).astype(np.float32)
    step = make_sp_dp_train_step(mesh, mod="64-QAM", snr_db=23.0, m_est=25, sps=2, lr=2.5e-3)
    params, opt = step.init(2)
    rx = torch.from_numpy(rng.normal(size=(2, 2, 2, 200)).astype(np.float32) * 0.5)
    t0 = time.perf_counter()
    probe, (h_out, h_grad), st = run_ranks(mesh, [
        Call(_probe), Call(halo_roundtrip, (xh, gh, left, right)), step.call(params, opt, rx)])
    print(f"spawn+run {time.perf_counter() - t0:.2f} s", flush=True)
    print("collectives " + " ".join(f"{k}={v!r}" for k, v in probe.items()), flush=True)
    ref_out, ref_grad = _halo_ref(xh, gh, 2, left, right)
    print(f"halo max_abs_err out={float((h_out - ref_out).abs().max()):.3e} "
          f"grad={float((torch.cat(list(h_grad), -1) - ref_grad).abs().max()):.3e}", flush=True)

    dev = torch.device("cuda:0")
    const = make_constellation("64-QAM", 0.0)
    amps = torch.from_numpy(const.amps).to(dev)
    P = torch.from_numpy(np.asarray(const.P, np.float32)).to(dev)
    var = torch.full((2,), float(np.float32(demapper_noise_var(const, 23.0))), device=dev)
    w, h = (params[k].to(dev).requires_grad_() for k in ("w", "h"))
    x = rx.to(dev)
    q, _ = vae_le_dp_forward(w, x, amps, var, const.nu_sc, 2)
    loss, var_est = elbo_dp(q, x, h, amps, P)
    gw, gh_ = torch.autograd.grad(loss.sum(), (w, h))
    new_p, _ = adam_update({"w": w.detach(), "h": h.detach()},
                           {k: v.to(dev) for k, v in opt.items()}, {"w": gw, "h": gh_}, 2.5e-3, 0)
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
    ratio = float((st["grads"]["w"] * gw).sum() / (gw * gw).sum())
    print(f"step loss_rel={rel(st['loss'], loss.detach()):.3e} var_est_rel="
          f"{rel(st['var_est'], var_est):.3e} gw_rel={rel(st['grads']['w'], gw):.3e} "
          f"gh_rel={rel(st['grads']['h'], gh_):.3e} grad_ratio={ratio:.6f} "
          f"w_err={float((st['params']['w'] - new_p['w']).abs().max()):.3e} "
          f"h_err={float((st['params']['h'] - new_p['h']).abs().max()):.3e}", flush=True)

    dryrun_multichip(2, devices=["cuda:0"] * 2)

    cfg = dataclasses.replace(DpConfig(), num_frames=2)
    stats: dict = {}
    t0 = time.perf_counter()
    res = run_ranks(mesh, [sharded_call(cfg, 0, runs=2, mesh=mesh, stats=stats)[1]])[0]
    wall_sp = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = train_vae_dp(cfg, 0, runs=2)
    wall = time.perf_counter() - t0
    print(f"runner frames={cfg.num_frames} sharded_wall_s={wall_sp:.3f} (spawn included) "
          f"sharded_train_ms_per_frame={1e3 * stats['train_s'] / stats['frames']:.1f} "
          f"collective_share={stats['collective_s'] / stats['train_s']:.3f} "
          f"unsharded_ms_per_frame={1e3 * wall / cfg.num_frames:.1f} "
          f"max_dser_f0_1={float(np.abs(res['ser'] - ref['ser'])[..., :2].max()):.5f} "
          f"finite={bool(np.all(np.isfinite(res['ser'])))} card={card!r}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
