"""Self-certification of the dp x sp sharded path (the counterpart of the JAX
package's ``__graft_entry__.py: dryrun_multichip``).

``dryrun_multichip`` runs the whole sharded experiment on a mesh of ranks
at tiny shapes and holds it to the single-device runner on the same draws;
``halo_roundtrip`` is the per-rank half of a check of ``halo_exchange``
alone (forward and backward) against the zero-padded gathered array.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import resolve_device
from ..train.dp import train_vae_dp
from ..utils.config import DpConfig
from .mesh import Comm, halo_exchange, make_mesh_2d
from .seqpar import train_vae_dp_sharded

__all__ = ["dryrun_multichip", "halo_roundtrip"]


def halo_roundtrip(comm: Comm, x: np.ndarray, g: np.ndarray, left: int, right: int):
    """Rank function: this rank's block of x (C, n_sp * L), extended by
    ``halo_exchange(left, right)``, and the gradient that the backward of
    <extended block, g[sp]> gives the block. Rank 0 returns (out (W, C,
    left + L + right), grad (W, C, L)) of every rank (host tensors), the
    others None; every dp row runs the same blocks."""
    ln = x.shape[-1] // comm.n_sp
    xb = torch.from_numpy(x[..., comm.sp * ln : (comm.sp + 1) * ln]).to(comm.device)
    xb.requires_grad_()
    out = halo_exchange(xb, left, right, comm)
    (gx,) = torch.autograd.grad(out, xb, torch.from_numpy(g[comm.sp]).to(comm.device))
    parts = comm.gather(torch.cat([out.detach().flatten(), gx.flatten()]))
    if parts is None:
        return None
    a = torch.stack(parts).cpu()
    n_out = out.numel()
    return (a[:, :n_out].reshape((-1,) + tuple(out.shape)),
            a[:, n_out:].reshape((-1,) + tuple(xb.shape)))


def dryrun_multichip(n_devices: int, device="cuda", devices=None) -> dict:
    """The full dp x sp sharded training loop, two frames, held to one device.

    The mesh is dp x sp over ``n_devices`` ranks with sp = 2 where it
    divides (else the largest sp <= 2 that does), on ``devices`` (default:
    one card per rank; ``["cuda:0"] * n`` shares one card under gloo; with
    ``device="cpu"`` every rank runs on the CPU). The configuration is the
    JAX dryrun's (64-QAM, 2 frames of 100 sp symbols, minibatches of 50
    sp). The sharded result must equal ``train_vae_dp`` on the same draws:
    every SER within 6 decisions of the frame (6 / n_frame_max). Raises
    AssertionError otherwise; returns {"n_dp", "n_sp", "d_ser", "tol",
    "ser"}.
    """
    dev = resolve_device(device)
    n_sp = 2
    while n_devices % n_sp != 0:
        n_sp -= 1
    n_dp = n_devices // n_sp
    if devices is None and dev.type == "cpu":
        devices = "cpu"
    mesh = make_mesh_2d(n_dp, n_sp, devices=devices)
    cfg = DpConfig(mod="64-QAM", num_frames=2, n_frame_max=100 * n_sp, batch_len=50 * n_sp,
                   n_lrhalf=10**9)
    res = train_vae_dp_sharded(cfg, 0, device=dev, runs=n_dp, mesh=mesh)
    ser = np.asarray(res["ser"])
    if ser.shape != (n_dp, 4, cfg.num_frames) or not np.all(np.isfinite(ser)):
        raise AssertionError(f"sharded SER {ser.shape}, finite {np.all(np.isfinite(ser))}")
    ref = train_vae_dp(cfg, 0, device=dev, runs=n_dp)
    d_ser = float(np.max(np.abs(ser - np.asarray(ref["ser"]))))
    tol = 6.0 / cfg.n_frame_max
    if d_ser > tol:
        raise AssertionError(f"sharded SER diverges from single-device: max|dSER|={d_ser:.4f} "
                             f"(tol {tol:.4f})\nsharded={ser.mean(axis=0).round(4).tolist()}\n"
                             f"single ={np.asarray(ref['ser']).mean(axis=0).round(4).tolist()}")
    print(f"dryrun_multichip OK: mesh dp={n_dp} x sp={n_sp} ({mesh.backend} on "
          f"{', '.join(mesh.devices)}), {cfg.num_frames} full frames of {cfg.n_frame_max} symbols, "
          f"max|dSER| vs single-device = {d_ser:.4f} (tol {tol:.4f}), "
          f"SER trajectory={ser.mean(axis=0).round(4).tolist()}", flush=True)
    return {"n_dp": n_dp, "n_sp": n_sp, "d_ser": d_ser, "tol": tol, "ser": ser}
