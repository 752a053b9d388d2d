"""Sequence-parallel (sp) x data-parallel (dp) sharded VAE training on
``torch.distributed`` (port of ``vae_equalizer_tpu/parallel/seqpar.py``).

The two parallel axes of the workload: ``dp``, the independent runs, with
no communication between them; ``sp``, the time axis of every minibatch.
The butterfly FIR and the ELBO's channel convolution need only a halo of
neighbour samples; the ELBO's global reductions (the reconstruction energy
C with its variance term E, and the KL) are ``sp_sum``'d, and the gradients
are all-reduced over sp, so every sp shard takes the same Adam step
(``parallel/mesh.py``).

Each rank holds its runs and its block of every minibatch. The received
samples are data: their halos (M//2 each side for the butterfly, which also
covers the ELBO's M//2 lag of rx) travel with the block when rank 0
scatters a frame. The posterior mean E_q[x] depends on the butterfly's
taps, so its 2 (M//2) left halo is exchanged live, with a gradient
(``halo_exchange``). Every mask is taken at the sample's global position
(the block's offset ``sp * L``); the frame's edges are zero, as in the
same-padded unsharded convolution.

``train_vae_dp_sharded`` is the single controller: the caller's process is
rank 0 (``parallel/mesh.py: run_ranks``) and makes every frame's channel
for all runs, exactly as ``train/dp.py: train_vae_dp`` does (its default
draws or the caller's ``draws``), scatters the ranks their blocks, trains
its own, gathers the losses, the variance estimates and the q / out
streams, and evaluates all runs with the unsharded runner's
``_finish_step_frame``; the result is ``train_vae_dp``'s. Inside a process
group started by another launcher (``torchrun``), every rank calls
``train_vae_dp_sharded_rank`` on its ``Comm``.

The sharded step is autograd through the port's model functions plus the
collectives, as JAX's is ``jax.value_and_grad`` (no fused kernel: JAX's
``eval_run_dp --sp`` refuses ``--pallas``).

Every rank drives its frames through ``train/harness.py: run_frame_loop``
with ``graph=False``, so ``compiled`` (one device-to-host copy of the
history at the end) and ``chunk_frames`` (one per chunk) keep JAX's
contract without a CUDA graph, which cannot capture gloo's host-side
collectives, and ``checkpoint`` follows one rule on every rank
(``_RankCheckpoint``): the state file holds the whole carry of all runs,
gathered to rank 0 at each save and scattered back on resume, so a file
written on one mesh resumes on another.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core import demapper_noise_var, make_constellation, resolve_device
from ..models import butterfly_init, dirac_taps_dp, soft_demap_dp
from ..models.losses import conv_bank, posterior_moments
from ..models.vae_le import butterfly_apply
from ..ops.frame_kernel import adam_schedule, adam_update, frame_opt_init
from ..train.dp import (
    _VAE_FIELDS,
    _batch_cut_weight_fn,
    _default_draws,
    _dp_result,
    _finish_step_frame,
    _frame_inputs,
    _margin_weight_fn,
    _setup,
)
from ..train.harness import Checkpoint, Progress, _new_hist, _sync, run_frame_loop
from ..utils.config import DpConfig
from .mesh import Call, Comm, Mesh, halo_exchange, make_mesh_2d, run_ranks, sp_sum

__all__ = [
    "halo_exchange",
    "make_mesh_2d",
    "make_sp_dp_train_step",
    "sharded_call",
    "sp_dp_step",
    "train_vae_dp_sharded",
    "train_vae_dp_sharded_rank",
    "train_vae_flex_dp_sharded",
]


def _sp_butterfly(w: torch.Tensor, xh: torch.Tensor, sps: int) -> torch.Tensor:
    """Sequence-parallel butterfly FIR: a local block carrying its M//2 halo
    each side (..., 2, 2, M//2 + L + M//2) -> the block's outputs (..., 2, 2,
    L // sps); requires L % sps == 0 and M odd."""
    return butterfly_apply(w, xh, sps, pad=0)


def _sp_elbo(q, rx_h, h_est, amps, P, sps: int, n_global: int, comm: Comm, eps: float = 1e-12):
    """Sequence-parallel DP ELBO on a local block: halo'd convolution and
    ``sp_sum``'d global reductions. Equals ``models.losses.elbo_dp`` on the
    gathered arrays (up to the order of the sums).

    q (..., 2, 2n, L // sps) the block's posteriors; rx_h (..., 2, 2, mh + L)
    its samples with the mh = M//2 samples before it (zero before the
    frame); h_est (..., 2, 2, 2, M). Returns (loss (...), var_est (..., 2)),
    the same on every sp rank.
    """
    mh = h_est.shape[-1] // 2
    mh2 = 2 * mh
    ln = rx_h.shape[-1] - mh
    dev = q.device
    t = comm.sp * ln + torch.arange(ln, device=dev)  # the samples' global positions
    rx, rx_lag = rx_h[..., mh:], rx_h[..., :ln]  # rx[n], and rx[n - mh] aligned with D[n]

    eq, eq2 = posterior_moments(q, amps, sps)  # (..., 2, 2, L)
    var = eq2 - eq * eq

    # D = h (*) E_q[x] over global positions: E_q[x]'s 2 mh left halo covers
    # the convolution's support; D counts from global n = 2 mh on
    h = h_est[..., : mh2 + 1]
    eq_h = halo_exchange(eq.flatten(-3, -2), mh2, 0, comm)  # (..., 4, 2 mh + L)
    d = torch.einsum("...oij,...inj->...on", conv_bank(h), eq_h.unfold(-1, mh2 + 1, 1))
    d = d.unflatten(-2, (2, 2))  # (..., chi, re/im, L)
    d_valid = (t >= mh2).to(d.dtype)

    # C = sum_{[mh, N - mh)} rx^2 - 2 <rx[n - mh], D[n]> + ||D||^2 + E
    rx_mask = ((t >= mh) & (t < n_global - mh)).to(rx.dtype)
    c = torch.sum(rx * rx * rx_mask, dim=(-2, -1))
    c = c - 2.0 * torch.sum((rx_lag[..., 0, :] * d[..., 0, :] + rx_lag[..., 1, :] * d[..., 1, :])
                            * d_valid, dim=-1)
    c = c + torch.sum(d * d * d_valid, dim=(-2, -1))

    # E: S[nu, j] = the sum of Var over the global window [2 mh - j, N - j)
    j = torch.arange(mh2 + 1, device=dev)[:, None]
    win = ((t >= mh2 - j) & (t < n_global - j)).to(var.dtype)  # (taps, L)
    s = torch.einsum("...nt,jt->...nj", var.sum(dim=-2), win)
    e = torch.einsum("...xnj,...nj->...x", torch.sum(h * h, dim=-2), s)

    # KL over the global symbol positions [mh, N_sym - mh)
    ts = comm.sp * ln // sps + torch.arange(q.shape[-1], device=dev)
    kl_mask = ((ts >= mh) & (ts < n_global // sps - mh)).to(q.dtype)
    p_col = P.repeat(2)[:, None]
    kl = torch.sum(-q * torch.log(q / p_col + eps) * kl_mask, dim=(-3, -2, -1))

    tot = sp_sum(torch.cat([c + e, kl[..., None]], dim=-1), comm)  # one psum for C and KL
    c, kl = tot[..., :2], tot[..., 2]
    n_eff = n_global - mh2
    return torch.sum(n_eff * torch.log(c), dim=-1) - kl, (c / n_eff).detach()


def sp_dp_step(comm: Comm, params: dict, xh: torch.Tensor, amps, var, nu_sc: float, P, sps: int,
               n_global: int):
    """One sharded minibatch of this rank's runs: the loss and its gradient.

    params {"w" (R, 2, 4, M), "h" (R, 2, 2, 2, M)}; xh (R, 2, 2, M//2 + L +
    M//2) this rank's block of the minibatch with its halo; n_global the
    minibatch's samples. Returns (loss (R,), var_est (R, 2), grads {"w",
    "h"}, q (R, 2, 2n, L // sps), out (R, 2, 2, L // sps)): the loss and
    grads are the whole minibatch's, the same on every sp rank (autograd of
    the local terms, then the gradients summed over sp once).
    """
    w, h = (params[k].detach().requires_grad_() for k in ("w", "h"))
    pad, mh = w.shape[-1] // 2, h.shape[-1] // 2
    out = _sp_butterfly(w, xh, sps)
    q = soft_demap_dp(out, amps, var, nu_sc)
    loss, var_est = _sp_elbo(q, xh[..., pad - mh : xh.shape[-1] - pad], h, amps, P, sps, n_global,
                             comm)
    gw, gh = torch.autograd.grad(loss.sum(), (w, h))  # runs are independent
    g = comm.all_reduce_sp(torch.cat([gw.flatten(), gh.flatten()]))  # psum over sp
    grads = {"w": g[: gw.numel()].view_as(gw), "h": g[gw.numel():].view_as(gh)}
    return loss.detach(), var_est, grads, q.detach(), out.detach()


def _split_blocks(x: torch.Tensor, mesh: Mesh, pad: int) -> list[torch.Tensor]:
    """Minibatches of all runs x (R, S, 2, 2, L) -> per rank (S, R / n_dp, 2,
    2, L / n_sp + 2 pad): its runs and its block of every minibatch with
    ``pad`` samples of halo each side (zero beyond the minibatch)."""
    R, S = x.shape[:2]
    ln = x.shape[-1] // mesh.n_sp
    xp = torch.nn.functional.pad(x, (pad, pad)).unfold(-1, ln + 2 * pad, ln)  # (R, S, 2, 2, sp, l)
    xp = xp.reshape((mesh.n_dp, R // mesh.n_dp) + xp.shape[1:]).permute(0, 5, 2, 1, 3, 4, 6)
    return list(xp.reshape((mesh.size, S, R // mesh.n_dp, 2, 2, ln + 2 * pad)).unbind(0))


def _pack(loss, var_est, q, out) -> torch.Tensor:
    """A step's per-run results -> (R, 3 + q + out) float32 rows."""
    return torch.cat([loss[:, None], var_est, q.flatten(1), out.flatten(1)], dim=1)


def _unpack(parts: list, mesh: Mesh, n_lev: int, bl: int):
    """The ranks' stacked rows (S, R_loc, K) -> all runs' (losses (S, R),
    var_est (S, R, 2), q (S, R, 2, 2n, bl), out (S, R, 2, 2, bl)): runs in
    dp order, each minibatch's blocks in sp order; loss and var_est from
    sp rank 0 (every sp rank holds the same)."""
    a = torch.stack(parts).unflatten(0, (mesh.n_dp, mesh.n_sp))  # (dp, sp, S, R_loc, K)
    S, r_loc = a.shape[2:4]
    ln = bl // mesh.n_sp
    first = a[:, 0].permute(1, 0, 2, 3).reshape(S, mesh.n_dp * r_loc, -1)
    nq = 2 * 2 * n_lev * ln

    def blocks(lo, hi, rows):  # (dp, sp, S, R_loc, rows * ln) -> (S, R, 2, rows, bl)
        x = a[..., lo:hi].unflatten(-1, (2, rows, ln)).permute(2, 0, 3, 4, 5, 1, 6)
        return x.reshape(S, mesh.n_dp * r_loc, 2, rows, bl)

    return first[..., 0], first[..., 1:3], blocks(3, 3 + nq, 2 * n_lev), blocks(3 + nq, None, 2)


@dataclasses.dataclass(frozen=True)
class _Plan:
    """A sharded experiment's shapes (JAX's refusals checked)."""

    runs: int
    n_frame: int  # symbols per frame
    n_steps: int  # minibatches (windows) per frame
    mb_len: int  # samples per minibatch
    hop: int  # samples between minibatch starts
    pad: int  # halo samples each side of a block
    crop: slice  # the recorded symbols of a minibatch
    rec0: int  # the recorded stream's first symbol in the frame
    n_rec: int  # symbols of the recorded stream


def _plan(cfg: DpConfig, mesh: Mesh, runs, flex_windows: bool) -> _Plan:
    """JAX's checks and shapes (parallel/seqpar.py:270-295)."""
    runs = mesh.n_dp if runs is None else runs
    if runs % mesh.n_dp != 0:
        raise ValueError(f"runs={runs} must be a multiple of the dp axis ({mesh.n_dp})")
    bl = cfg.batch_len
    n_frame = cfg.n_frame_max // bl * bl
    mb_len = bl * cfg.sps
    if flex_windows:
        if bl % cfg.flex_step != 0:
            raise ValueError("flex sp-sharding needs batch_len %% flex_step == 0")
        fs = cfg.flex_step
        n_steps = (n_frame - bl) // fs
        crop0 = (bl - fs) // 2
        crop, rec0, hop = slice(crop0, crop0 + fs), bl // 2, fs * cfg.sps
    else:
        n_steps, crop, rec0, hop = n_frame // bl, slice(None), 0, mb_len
    if mb_len % (mesh.n_sp * cfg.sps) != 0:
        raise ValueError(f"minibatch length {mb_len} must split over sp={mesh.n_sp} whole symbols")
    if cfg.m_est % 2 == 0:
        raise ValueError("sp sharding requires odd M_est (symmetric halo)")
    n_rec = n_steps * (cfg.flex_step if flex_windows else bl)
    return _Plan(runs, n_frame, n_steps, mb_len, hop, cfg.m_est // 2, crop, rec0, n_rec)


# dims of a run's w / h (and of their Adam moments)
_TAIL = {"w": 3, "h": 4, "mw": 3, "vw": 3, "mh": 4, "vh": 4}


def _local_runs(tree: dict, runs: int, comm: Comm) -> dict:
    """params (or Adam moments) with or without a runs axis -> this rank's
    runs, on its device."""
    r_loc = runs // comm.mesh.n_dp
    out = {}
    for k, v in tree.items():
        v = torch.as_tensor(v, dtype=torch.float32).to(comm.device)
        v = v.expand((runs,) + v.shape[-_TAIL[k]:])
        out[k] = v[comm.dp * r_loc : (comm.dp + 1) * r_loc].contiguous()
    return out


def _flat_carry(params: dict, opt: dict) -> torch.Tensor:
    """params and Adam moments of n runs -> (n, K) float32, one row per run
    (the leaves in ``_TAIL``'s order)."""
    both = {**params, **opt}
    return torch.cat([both[k].flatten(1) for k in _TAIL], dim=1)


def _unflat_carry(flat: torch.Tensor, like: dict) -> tuple[dict, dict]:
    """``_flat_carry``'s rows -> (params, opt) of ``flat``'s runs, each leaf
    shaped as in ``like`` past its runs axis."""
    out, i = {}, 0
    for k in _TAIL:
        size = like[k][0].numel()
        out[k] = flat[:, i : i + size].reshape((flat.shape[0],) + like[k].shape[1:]).contiguous()
        i += size
    return {k: out[k] for k in ("w", "h")}, {k: out[k] for k in ("mw", "vw", "mh", "vh")}


def _carry_template(m_est: int, runs: int, device) -> tuple:
    """The whole carry of ``runs`` runs, zeros: params, Adam moments and the
    step count, as the state file holds them."""
    params = {"w": torch.zeros((runs, 2, 4, m_est), device=device),
              "h": torch.zeros((runs, 2, 2, 2, m_est), device=device)}
    return params, frame_opt_init(params), torch.zeros((1,), dtype=torch.int64, device=device)


def _ident(flex_windows: bool) -> str:
    """A sharded run's checkpoint identity: the sweep's runner name."""
    return "VAEflex-SP" if flex_windows else "VAE-SP"


class _RankCheckpoint(Checkpoint):
    """A sharded run's ``Checkpoint`` on one rank.

    The file is ``Checkpoint``'s, written and read by rank 0 alone. It holds
    the whole carry of all R runs (w, h and the four Adam moments, each with
    its leading (R,) axis, and the step count), the histories, the next
    frame, the identity and rank 0's draw-generator state, so it does not
    depend on the mesh's split. Every rank finds the due frames by the same
    rule (``due``), so no collective is added to the other frames: at a
    save, each rank sends its carry as one flat row per run through
    ``gather`` and rank 0 writes sp rank 0's rows of every dp row. On
    resume rank 0 reads the file (``ValueError`` where it does not match),
    ``scatter``s the next frame and the step count to every rank, then each
    dp row the rows of its runs. ``saves`` (rank 0): (frame, gather seconds,
    write seconds) of every save.
    """

    def __init__(self, comm: Comm, runs: int, m_est: int, path=None, every: int = 0,
                 rng: torch.Generator | None = None, ident: str = ""):
        super().__init__(path, every, rng, ident)
        self.comm, self.runs, self.m_est, self.saves = comm, runs, m_est, []

    def save(self, done: int, carry, hist: dict) -> None:
        params, opt, count = carry
        t0 = time.perf_counter()
        parts = self.comm.gather(_flat_carry(params, opt))
        if parts is None:
            return
        flat = torch.cat([parts[r] for r in self.comm.mesh.dp_ranks(0)])
        t1 = time.perf_counter()
        super().save(done, (*_unflat_carry(flat, {**params, **opt}), count), hist)
        self.saves.append((done, t1 - t0, time.perf_counter() - t1))

    def resume(self, carry, hist: dict):
        if self.path is None:
            return 0, carry
        comm, (params, opt, count) = self.comm, carry
        mesh, r_loc = comm.mesh, self.runs // comm.mesh.n_dp
        head = rows = None
        if comm.rank == 0:
            start, full = super().resume(_carry_template(self.m_est, self.runs, comm.device), hist)
            head = [torch.tensor([start, int(full[2])], device=comm.device)] * mesh.size
            flat = _flat_carry(full[0], full[1])
            rows = [flat[(r // mesh.n_sp) * r_loc : (r // mesh.n_sp + 1) * r_loc]
                    for r in range(mesh.size)]
        start, step = comm.scatter(head, (2,), torch.int64).tolist()
        if start == 0:
            return 0, carry
        like = {**params, **opt}
        flat = comm.scatter(rows, (r_loc, sum(v[0].numel() for v in like.values())))
        return start, (*_unflat_carry(flat, like), torch.full_like(count, step))


def train_vae_dp_sharded_rank(comm: Comm, cfg: DpConfig, seed: int, runs: int | None = None,
                              params_init=None, flex_windows: bool = False, compiled: bool = False,
                              chunk_frames: int = 1, checkpoint=None, checkpoint_every: int = 0,
                              progress: Progress = None, draws=None, stats: dict | None = None):
    """This rank's part of ``train_vae_dp_sharded`` (every rank of ``comm``'s
    mesh calls it; ``progress``, ``draws`` and ``stats`` are rank 0's).
    Returns the result dict on rank 0, None elsewhere.

    ``stats`` (a dict, rank 0): "train_s", the host seconds of the sharded
    training (steps and collectives, each frame's work finished on the
    device), "collective_s", the seconds of it in collectives (each started
    after the device finished the work before it), "frames", and "saves",
    (frame, gather seconds, write seconds) of every checkpoint save.
    """
    mesh = comm.mesh
    plan = _plan(cfg, mesh, runs, flex_windows)
    dev, R = comm.device, plan.runs
    r_loc, S, pad = R // mesh.n_dp, plan.n_steps, plan.pad
    ln = plan.mb_len // mesh.n_sp
    const, var, gen, amps, P = _setup(cfg, plan.n_frame, dev)
    params = params_init or {"w": butterfly_init(cfg.m_est), "h": dirac_taps_dp(cfg.m_est)}
    params = _local_runs(params, R, comm)
    sched = adam_schedule(cfg.num_frames * S, float(cfg.n_lrhalf) * S, dev)
    offsets = torch.arange(S, device=dev)
    block_shape = (S, r_loc, 2, 2, ln + 2 * pad)
    comm.sync_timing = stats is not None

    def train(params, opt, count, xb):
        """The frame's S sharded steps + Adam on this rank's blocks xb."""
        scalars = sched.index_select(0, count + offsets)
        rows = []
        for m in range(S):
            loss, var_est, grads, q, out = sp_dp_step(comm, params, xb[m], amps, var,
                                                      const.nu_sc, P, cfg.sps, plan.mb_len)
            params, opt = adam_update(params, opt, grads, cfg.lr, scalars[m])
            rows.append(_pack(loss, var_est, q, out))
        return params, opt, torch.stack(rows)

    count = torch.zeros((1,), dtype=torch.int64, device=dev)
    carry = (params, frame_opt_init(params), count)
    rng = _default_draws(seed, dev) if comm.rank == 0 and draws is None else None
    ckpt = _RankCheckpoint(comm, R, cfg.m_est, checkpoint, checkpoint_every, rng,
                           _ident(flex_windows))
    loop = dict(num_frames=cfg.num_frames, ckpt=ckpt, compiled=compiled,
                chunk_frames=chunk_frames, graph=False)
    if comm.rank != 0:
        nothing = torch.zeros((0,), device=dev)  # the other ranks record no metrics

        def rank_step(carry):
            params, opt, count = carry
            params, opt, rows = train(params, opt, count, comm.scatter(None, block_shape))
            comm.gather(rows)
            return (params, opt, count + S), nothing

        (params, _, _), _ = run_frame_loop(rank_step, carry, (), (), **loop)
        comm.gather(torch.cat([params["w"].flatten(1), params["h"].flatten(1)], dim=1))
        return None

    weight_fn = (_margin_weight_fn(plan.n_rec) if flex_windows
                 else _batch_cut_weight_fn(S, cfg.batch_len, cfg.n_cut))
    if stats is not None:
        stats.update(train_s=0.0, collective_s=0.0, frames=0, saves=ckpt.saves)

    def frame_step(carry, theta, *drawn):
        params, opt, count = carry
        levels, noise = drawn or gen.draws(rng, R)
        rx, tx, sigma = gen.physics(theta, levels, noise)
        win = rx.unfold(-1, plan.mb_len, plan.hop)[..., :S, :].movedim(-2, 1)  # (R, S, 2, 2, mb)
        xb = comm.scatter(_split_blocks(win, mesh, pad), block_shape)
        if stats is not None:
            _sync(dev)
            t0, c0 = time.perf_counter(), comm.collective_s
        params, opt, rows = train(params, opt, count, xb)
        parts = comm.gather(rows)
        if stats is not None:
            _sync(dev)
            stats["train_s"] += time.perf_counter() - t0
            stats["collective_s"] += comm.collective_s - c0
            stats["frames"] += 1
        losses, var_est, q, out = _unpack(parts, mesh, amps.shape[0], cfg.batch_len)
        time_major = lambda a: a[..., plan.crop].movedim(0, -2).flatten(-2)  # noqa: E731
        tx = tx[..., plan.rec0 : plan.rec0 + plan.n_rec]
        packed = _finish_step_frame(losses, time_major(q), time_major(out), var_est.movedim(0, 1),
                                    tx, const, amps, P, var, weight_fn, sigma)
        return (params, opt, count + S), packed

    (params, _, _), hist = run_frame_loop(
        frame_step, carry, (_frame_inputs(cfg, dev),), _VAE_FIELDS, runs=R, progress=progress,
        host_rows=None if rng is not None else (lambda f: draws(f, R)), **loop)
    flat = comm.gather(torch.cat([params["w"].flatten(1), params["h"].flatten(1)], dim=1))
    flat = torch.cat([flat[r] for r in mesh.dp_ranks(0)])  # sp rank 0 of each dp row
    nw = params["w"][0].numel()
    params = {"w": flat[:, :nw].reshape((R,) + params["w"].shape[1:]),
              "h": flat[:, nw:].reshape((R,) + params["h"].shape[1:])}
    return _dp_result(hist, var, params=params)


def _default_mesh(device) -> Mesh:
    """JAX's default: dp x sp over every card with sp = 2 where the count is
    even (sp = 1 otherwise); one rank on the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return make_mesh_2d(1, 1, devices=dev)
    n = torch.cuda.device_count()
    return make_mesh_2d(n // 2, 2) if n % 2 == 0 else make_mesh_2d(n, 1)


def sharded_call(cfg: DpConfig, seed: int, device="cuda", progress: Progress = None,
                 runs: int | None = None, mesh: Mesh | None = None, params_init=None,
                 compiled: bool = False, checkpoint=None, checkpoint_every: int = 0,
                 chunk_frames: int = 1, flex_windows: bool = False, draws=None,
                 stats: dict | None = None) -> tuple[Mesh, Call]:
    """(mesh, the ``Call`` of ``train_vae_dp_sharded_rank``) for
    ``train_vae_dp_sharded``'s arguments, checked before any rank starts;
    ``run_ranks(mesh, [call, ...])`` runs it with other calls on the same
    ranks. A ``checkpoint`` file that the run would refuse (another runner,
    shapes or draws) raises ``ValueError`` here."""
    if chunk_frames < 1:
        raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
    mesh = _default_mesh(device) if mesh is None else mesh
    plan = _plan(cfg, mesh, runs, flex_windows)
    if checkpoint is not None and not compiled:  # compiled mode ignores it, as in JAX
        rng = _default_draws(seed, mesh.devices[0]) if draws is None else None
        Checkpoint(checkpoint, checkpoint_every, rng, _ident(flex_windows)).check(
            _carry_template(cfg.m_est, plan.runs, "cpu"),
            _new_hist(_VAE_FIELDS, cfg.num_frames, plan.runs))
    if params_init is not None:  # to the host: the spawned ranks unpickle it
        params_init = {k: torch.as_tensor(np.asarray(v.cpu() if torch.is_tensor(v) else v))
                       for k, v in params_init.items()}
    return mesh, Call(train_vae_dp_sharded_rank, (cfg, seed),
                      dict(runs=runs, params_init=params_init, flex_windows=flex_windows,
                           compiled=compiled, chunk_frames=chunk_frames, checkpoint=checkpoint,
                           checkpoint_every=checkpoint_every),
                      dict(progress=progress, draws=draws, stats=stats))


def train_vae_dp_sharded(cfg: DpConfig, seed: int, device="cuda", progress: Progress = None,
                         runs: int | None = None, mesh: Mesh | None = None, params_init=None,
                         compiled: bool = False, checkpoint=None, checkpoint_every: int = 0,
                         chunk_frames: int = 1, flex_windows: bool = False, draws=None) -> dict:
    """The DP VAE online experiment on a dp x sp mesh of ranks.

    ``train/dp.py: train_vae_dp``'s frame loop (theta-drift channel, the
    minibatch optimizer steps, the synchronized SER / MI eval) with the runs
    split over the mesh's ``dp`` axis and every minibatch's samples over
    ``sp`` (halo'd butterfly, ``sp_sum``'d ELBO, gradients summed over sp).
    Equals ``train_vae_dp(cfg, seed, runs=runs)`` (its autograd mode, the
    same draws) up to the order of float sums.

    ``mesh``: ``make_mesh_2d(n_dp, n_sp, devices=...)``; by default dp x 2
    over every card (sp 1 for an odd count), one rank for ``device="cpu"``.
    The ranks run on the mesh's devices; this process is rank 0.
    ``flex_windows=True`` runs VAEflex (``train_vae_flex_dp_sharded``).
    ``draws(frame, R)`` as in ``train_vae_dp``; ``runs`` defaults to n_dp.

    ``compiled`` (one device-to-host copy of the history at the end; no
    ``progress``; ``checkpoint`` ignored) and ``chunk_frames=k`` (one copy
    per k frames; ``progress`` per frame, k at a time) are JAX's modes
    without a CUDA graph (gloo's collectives pass through the host): every
    rank calls the step eagerly, and the results equal the loop mode's bit
    for bit. ``checkpoint`` / ``checkpoint_every`` = K: JAX's rule (the loop
    mode saves after every K-th frame, a chunked run at a chunk's end once
    K frames have run since the last save) and state file; the file holds
    every run's carry, gathered to rank 0 (``_RankCheckpoint``), so a run
    killed on one mesh resumes on any mesh of the same runs.

    Refuses (JAX's ValueErrors): runs not a multiple of n_dp, a minibatch of
    2 batch_len samples not split by n_sp * sps, an even M_est, and for
    VAEflex batch_len not a multiple of flex_step. Returns {"ser" (R, 4, F),
    "mi" (R, 2, F), "var_est" (R, 2, F), "var" (2,), "params" {"w", "h"}
    (R, ...)}.
    """
    mesh, call = sharded_call(cfg, seed, device, progress, runs, mesh, params_init, compiled,
                              checkpoint, checkpoint_every, chunk_frames, flex_windows, draws)
    return run_ranks(mesh, [call])[0]


def train_vae_flex_dp_sharded(cfg: DpConfig, seed: int, device="cuda", progress: Progress = None,
                              runs: int | None = None, mesh: Mesh | None = None,
                              params_init=None, compiled: bool = False, checkpoint=None,
                              checkpoint_every: int = 0, chunk_frames: int = 1,
                              draws=None) -> dict:
    """VAEflex (overlapping sliding windows, central crops) on a dp x sp
    mesh: ``train_vae_dp_sharded`` with ``flex_windows=True``; each window's
    samples are sp-sharded like a minibatch, and the recorded stream and
    eval are ``train/dp.py: train_vae_flex_dp``'s."""
    return train_vae_dp_sharded(cfg, seed, device, progress, runs, mesh, params_init, compiled,
                                checkpoint, checkpoint_every, chunk_frames, True, draws)


@dataclasses.dataclass(frozen=True)
class SpDpTrainStep:
    """One dp x sp training step of the DP VAE (JAX's ``make_sp_dp_train_step``):
    ``init(R)`` gives Dirac params and zero Adam moments for R runs; called
    as ``(params, opt, rx, step)`` it runs Adam step ``step`` (from 0) of every
    run on rx (R, 2, 2, N), its runs over dp and its samples over sp, and
    returns {"loss" (R,), "var_est" (R, 2), "grads" (the raw gradients),
    "params", "opt"} on rank 0's device; ``call`` is that step as a ``Call``
    for ``run_ranks``."""

    mesh: Mesh
    mod: str = "64-QAM"
    nu: float = 0.0
    snr_db: float = 23.0
    m_est: int = 25
    sps: int = 2
    lr: float = 2.5e-3

    def init(self, n_runs: int) -> tuple[dict, dict]:
        if n_runs % self.mesh.n_dp != 0:
            raise ValueError(f"runs={n_runs} must be a multiple of the dp axis ({self.mesh.n_dp})")
        params = {"w": butterfly_init(self.m_est), "h": dirac_taps_dp(self.m_est)}
        params = {k: v.expand((n_runs,) + v.shape).contiguous() for k, v in params.items()}
        return params, frame_opt_init(params)

    def call(self, params: dict, opt: dict, rx, step: int = 0) -> Call:
        host = lambda d: {k: torch.as_tensor(v).detach().cpu() for k, v in d.items()}  # noqa: E731
        rx = torch.as_tensor(rx)
        if rx.shape[-1] % (self.mesh.n_sp * self.sps) != 0:
            raise ValueError(f"{rx.shape[-1]} samples must split over sp={self.mesh.n_sp} whole "
                             "symbols")
        return Call(_train_step_rank, (self, host(params), host(opt), step, tuple(rx.shape)),
                    root=dict(rx=rx))

    def __call__(self, params: dict, opt: dict, rx, step: int = 0) -> dict:
        return run_ranks(self.mesh, [self.call(params, opt, rx, step)])[0]


def make_sp_dp_train_step(mesh: Mesh, mod: str = "64-QAM", nu: float = 0.0, snr_db: float = 23.0,
                          m_est: int = 25, sps: int = 2, lr: float = 2.5e-3) -> SpDpTrainStep:
    """The dp x sp training step on ``mesh`` (``SpDpTrainStep``)."""
    return SpDpTrainStep(mesh, mod, nu, snr_db, m_est, sps, lr)


def _train_step_rank(comm: Comm, spec: SpDpTrainStep, params: dict, opt: dict, step: int,
                     shape: tuple, rx=None) -> dict | None:
    """``SpDpTrainStep``'s step on this rank: rank 0 scatters ``rx``, every
    rank steps its runs on its block, rank 0 gathers every run's results."""
    mesh, dev = comm.mesh, comm.device
    const = make_constellation(spec.mod, spec.nu)
    amps = torch.from_numpy(const.amps).to(dev)
    P = torch.from_numpy(np.asarray(const.P, np.float32)).to(dev)
    var = torch.full((2,), float(np.float32(demapper_noise_var(const, spec.snr_db))), device=dev)
    R, n = shape[0], shape[-1]
    loc = _local_runs(params, R, comm)
    opt = _local_runs(opt, R, comm)
    pad = spec.m_est // 2
    blocks = None if rx is None else _split_blocks(rx.to(dev)[:, None], mesh, pad)
    xb = comm.scatter(blocks, (1, R // mesh.n_dp, 2, 2, n // mesh.n_sp + 2 * pad))[0]
    loss, var_est, grads, _, _ = sp_dp_step(comm, loc, xb, amps, var, const.nu_sc, P, spec.sps, n)
    new_p, new_o = adam_update(loc, opt, grads, spec.lr, step)
    trees = {"grads": grads, "params": new_p, "opt": new_o}
    leaves = [(t, k) for t in trees for k in trees[t]]
    row = torch.cat([loss[:, None], var_est] + [trees[t][k].flatten(1) for t, k in leaves], dim=1)
    parts = comm.gather(row)
    if parts is None:
        return None
    a = torch.cat([parts[r] for r in mesh.dp_ranks(0)])  # sp rank 0 of each dp row
    res, i = {"loss": a[:, 0], "var_est": a[:, 1:3], **{t: {} for t in trees}}, 3
    for t, k in leaves:
        size = trees[t][k][0].numel()
        res[t][k] = a[:, i : i + size].reshape((R,) + trees[t][k].shape[1:])
        i += size
    return res
