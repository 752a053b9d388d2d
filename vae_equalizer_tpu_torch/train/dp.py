"""Optical dual-pol processing loops: VAE and VAEflex online training (the
flagship ``Eval_run_DP`` path) and the CMA / CMAbatch / CMAflex baselines.

Port of ``vae_equalizer_tpu/train/dp.py``: ``train_vae_dp`` and
``train_vae_flex_dp`` in their three modes (``_setup``, ``_frame_inputs``,
``_vae_optimizer`` as ``ops/frame_kernel.py: adam_update``, both branches of
``_dp_frame_eval_mb`` (the stats branch also as kernel K, ``ops/eval_kernel.py``),
``_finish_vae_frame``, ``_run_frame_kernel_experiment``
and the per-step ``lax.scan`` loops) and ``run_cma_dp`` (``_dp_frame_eval``).
Frame semantics follow the reference (func_VAELE_DP_MQAM_shaping.py:17-95,
func_VAEflex_DP_MQAM_shaping.py:16-90, func_CMA*_DP_MQAM_shaping.py): every
frame draws fresh channel data with the polarization angle advanced by
theta_diff, trains or adapts online (``ops/``: one kernel launch per frame,
or per minibatch in the VAE's per-step modes, for all R runs), and measures
SER/MI on the frame's own outputs.

SER layout matches the reference: rows 0:2 per-pol SER of the constellation
output (PCS decision boundaries), rows 2:4 per-pol soft SER (IQ-flip family).
"""

from __future__ import annotations

import numpy as np
import torch

from ..channels import channel_ir, make_dp_simulator
from ..core import demapper_noise_var, make_constellation, resolve_device
from ..metrics import (
    cpe_dp,
    find_shift_dp,
    find_shift_symb_dp,
    mutual_information_ambiguity,
    mutual_information_ambiguity_mb_stats,
    ser_constell_shaping,
    ser_iqflip,
    ser_iqflip_from_dec,
)
from ..metrics.ser import _decode_levels
from ..metrics.sync import _dp_shift_core
from ..models import (
    butterfly_init,
    cma_batch_dp,
    cma_dp,
    cma_flex_dp,
    dirac_taps_dp,
    elbo_dp,
    soft_demap_dp,
    vae_le_dp_forward,
)
from ..ops.cma_frame_kernel import cma_chunked_frame
from ..ops.cma_kernel import cma_dp_kernel
from ..ops.elbo_kernel import vae_dp_loss_and_grad
from ..ops.eval_kernel import SYNC_CORR_LEN, vae_dp_frame_eval
from ..ops.frame_kernel import adam_schedule, adam_update, frame_opt_init, vae_dp_frame_train
from ..utils.config import DpConfig
from ..utils.profiling import span
from .batching import RunShard, run_sharding
from .eval_utils import BatchCutWeight, MarginWeight, align_idx_dp, align_tx_dp
from .harness import Progress, pack_metrics, run_frame_loop
from .modes import check_pallas_mode

__all__ = ["run_cma_dp", "train_vae_dp", "train_vae_flex_dp"]

_VAE_FIELDS = (("loss", 1), ("ser_const", 2), ("ser_soft", 2), ("mi", 2),
               ("var_est", 2), ("snr_est_db", 1), ("shift", 2), ("r", 1), ("sigma_n", 1))
_CMA_FIELDS = (("loss", 1), ("ser_const", 2), ("ser_soft", 2), ("mi", 2),
               ("shift", 2), ("r", 1), ("sigma_n", 1))


def _setup(cfg: DpConfig, n_frame: int, device):
    """Constellation, demapper variance (2,), the channel simulator, amps, P."""
    const = make_constellation(cfg.mod, cfg.nu)
    h_up, _ = channel_ir(cfg.channel, cfg.sps)
    # float64 on the host, then float32 — as the JAX package folds it
    var = torch.full((2,), float(np.float32(demapper_noise_var(const, cfg.snr_db))),
                     dtype=torch.float32, device=device)
    gen = make_dp_simulator(const, cfg.snr_db, h_up, n_frame, cfg.sps, cfg.symb_rate, cfg.tau_cd,
                            cfg.tau_pmd, np.asarray(cfg.phi_iq), device=device)
    amps = torch.from_numpy(const.amps).to(device)
    P = torch.from_numpy(np.asarray(const.P, np.float32)).to(device)
    return const, var, gen, amps, P


def _frame_inputs(cfg: DpConfig, device) -> torch.Tensor:
    """Per-frame polarization angles (theta drift), float32 as in JAX."""
    return torch.tensor(np.float32(cfg.theta), device=device) + torch.tensor(
        np.float32(cfg.theta_diff), device=device) * torch.arange(
        cfg.num_frames, dtype=torch.float32, device=device)


def _roll_pol(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """jnp.roll over the size-2 pol axis by r in {0, 1}, per run."""
    return torch.where(r[..., None] != 0, x.flip(-1), x)


def _dp_frame_eval_mb(out_mb, dec_mb, eq_mb, mm_mb, s1_mb, tx, amps, P, nu_sc, var, weight_fn):
    """Sync -> align tx level indices -> masked SER (+ MI) from kernel B's
    eval streams (the JAX stats branch, train/dp.py:187-214): the plain
    version of kernel K (``ops/eval_kernel.py``), with its arguments.

    out_mb/dec_mb/mm_mb/s1_mb (m_max, R, 2, 2, L) and eq_mb (m_max, R, 2, L)
    as kernel B writes them (bfloat16 out / eq streams are evaluated in
    float32); tx (R, 2, 2, N = m_max L); P (n,) or (R, n), nu_sc a float or
    (R,), var (2,) or (R, 2); weight_fn as in ``_dp_frame_eval``.
    Returns per-run (ser_const, ser_soft, mi) (R, 2) and (shift (R, 2), r (R,)).
    """
    runs_first = lambda a: a.movedim(0, 1)  # (m_max, R, ...) -> (R, m_max, ...)
    out_mb, dec_mb, eq_mb, mm_mb, s1_mb = map(
        runs_first, (out_mb.float(), dec_mb, eq_mb.float(), mm_mb, s1_mb))
    time_major = lambda a: a.movedim(-4, -2).flatten(-2)  # (R, m, 2, 2, bl) -> (R, 2, 2, N)
    out_const, dec = time_major(out_mb), time_major(dec_mb)
    eq = eq_mb.movedim(-3, -2).flatten(-2)  # (R, m, 2, bl) -> (R, 2, N)
    num_lev = amps.shape[0]
    shift, r = _dp_shift_core(eq, tx, 21, corr_len=SYNC_CORR_LEN)
    shift_c, r_c = find_shift_symb_dp(out_const, tx, 21, corr_len=SYNC_CORR_LEN)
    idx = _decode_levels(tx, num_lev).to(torch.int8)

    def aligned(sh, rr):
        s0 = sh[..., 0, None, None]
        ms = sh.abs().max(dim=-1).values[..., None, None]
        return align_idx_dp(idx, sh, rr, lambda t: weight_fn(s0, ms, t))

    idx_al, w_al = aligned(shift, r)
    ser_soft = _roll_pol(ser_iqflip_from_dec(dec, None, num_lev, weight=w_al, tx_idx=idx_al), r)
    mi = _roll_pol(mutual_information_ambiguity_mb_stats(
        out_mb, mm_mb, s1_mb, None, amps, P, nu_sc, var, weight=w_al, tx_idx=idx_al), r)
    idx_al_c, w_al_c = aligned(shift_c, r_c)
    ser_const = _roll_pol(ser_constell_shaping(out_const, None, amps, nu_sc, var, weight=w_al_c,
                                               tx_idx=idx_al_c), r_c)
    return ser_const, ser_soft, mi, shift, r


def _vae_metrics(losses, ser_const, ser_soft, mi, var_est, shift, r, sigma, pow_mean):
    """A VAE frame's metrics packed (R, n_tot): losses (steps, R), var_est
    (R, steps, 2), the eval's per-run results, the channel's sigma (R,) and
    the source power (a float, or (R,) per run). The mean of var_est over the
    steps is a sequential sum (a cumulative sum's last row): a reduction
    would order that sum by how many runs share the tensor (its split of the
    steps over threads follows the number of outputs), and a run's metrics
    must not depend on that (run sharding, ``train/batching.py``)."""
    var_mean = var_est.cumsum(dim=-2)[..., -1, :] / var_est.shape[-2]
    snr_est = pow_mean / var_mean.mean(dim=-1)
    metrics = {
        "loss": losses[-1],
        "ser_const": ser_const,
        "ser_soft": ser_soft,
        "mi": mi,
        "var_est": var_mean,
        "snr_est_db": 10 * torch.log10(snr_est),
        "shift": shift.to(torch.float32),
        "r": r,
        "sigma_n": sigma,
    }
    return pack_metrics(metrics, _VAE_FIELDS, batch_ndim=1)


def _finish_vae_frame(losses, out_mb, var_est, tx, amps, P, var, nu_sc, pow_mean, weight_fn, sigma,
                      dec_mb, eq_mb, mm_mb, s1_mb):
    """Kernel B's streams (m_max, R, ...) -> evaluate -> packed metrics (R,
    n_tot). The eval is kernel K (``ops/eval_kernel.py``, one launch for all
    runs) on CUDA tensors and its plain version ``_dp_frame_eval_mb`` on the
    CPU. The eval constants P, var, nu_sc and pow_mean are shared, or per run
    (JAX ``_finish_vae_frame``'s overrides, train/dp.py:240-261)."""
    streams = (out_mb, dec_mb, eq_mb, mm_mb, s1_mb)
    if out_mb.is_cuda:
        res = vae_dp_frame_eval(*streams, tx, amps, P, nu_sc, var, weight_fn)
    else:
        res = _dp_frame_eval_mb(*streams, tx, amps, P, nu_sc, var, weight_fn)
    ser_const, ser_soft, mi, shift, r = res
    return _vae_metrics(losses, ser_const, ser_soft, mi, var_est.movedim(0, 1), shift, r, sigma,
                        pow_mean)


def _finish_step_frame(losses, q, out_const, var_est, tx, const, amps, P, var, weight_fn, sigma):
    """The per-step modes' streams -> evaluate the posteriors (the q branch of
    JAX's ``_dp_frame_eval_mb``, train/dp.py:216-231, which is
    ``_dp_frame_eval`` in minibatch memory order) -> packed metrics.
    q (R, 2, 2n, N) and out_const (R, 2, 2, N) time-major; losses (steps,
    R); var_est (R, steps, 2)."""
    ser_const, ser_soft, mi, (shift, r), _ = _dp_frame_eval(
        q, out_const, tx, amps, P, const.nu_sc, var, weight_fn)
    return _vae_metrics(losses, ser_const, ser_soft, mi, var_est, shift, r, sigma, const.pow_mean)


def _dp_frame_eval(q, out_const, tx, amps, P, nu_sc, var, weight_fn):
    """Sync -> align tx -> masked SER (+ MI) from the posteriors (the JAX
    q-stream eval, train/dp.py:116-150).

    q (R, 2, 2n, N); out_const/tx (R, 2, 2, N); weight_fn(shift0, max_shift,
    t) -> the eval mask at symbol positions t, here (R, N) for shift0 and
    max_shift (R, 1) and t (N,). Returns per-run (ser_const, ser_soft, mi)
    (R, 2), the posterior sync (shift (R, 2), r (R,)) and the constellation
    sync (shift_c, r_c).
    """
    t = torch.arange(tx.shape[-1], device=tx.device)

    def aligned(sh, rr):
        w = weight_fn(sh[..., 0, None], sh.abs().max(dim=-1).values[..., None], t)
        return align_tx_dp(tx, sh, rr, w)

    shift, r = find_shift_dp(q, tx, 21, amps, corr_len=SYNC_CORR_LEN)
    tx_al, w_al = aligned(shift, r)
    # aligned metrics are per EQUALIZER pol j; report per tx pol i = (j + r) % 2
    ser_soft = _roll_pol(ser_iqflip(q, tx_al, weight=w_al), r)
    mi = _roll_pol(mutual_information_ambiguity(q, tx_al, amps, P, weight=w_al), r)
    shift_c, r_c = find_shift_symb_dp(out_const, tx, 21, corr_len=SYNC_CORR_LEN)
    tx_al_c, w_al_c = aligned(shift_c, r_c)
    ser_const = _roll_pol(ser_constell_shaping(out_const, tx_al_c, amps, nu_sc, var, weight=w_al_c),
                          r_c)
    return ser_const, ser_soft, mi, (shift, r), (shift_c, r_c)


def _finish_cma_frame(out, e, tx, sigma, const, amps, P, var, n_cut: int, weight_fn):
    """One CMA frame's equalizer streams -> CPE -> soft demapper -> eval ->
    packed metrics (R, n_tot). out/tx (R, 2, 2, N); e (R, N, 2); sigma (R,)."""
    cut = slice(n_cut, -n_cut)
    out = cpe_dp(out[..., cut])
    q = soft_demap_dp(out, amps, var, const.nu_sc)
    ser_const, ser_soft, mi, _, (shift_c, r_c) = _dp_frame_eval(
        q, out, tx[..., cut], amps, P, const.nu_sc, var, weight_fn)
    metrics = {
        "loss": e.sum(dim=(-2, -1)),
        "ser_const": ser_const,
        "ser_soft": ser_soft,
        "mi": mi,
        "shift": shift_c.to(torch.float32),
        "r": r_c,
        "sigma_n": sigma,
    }
    return pack_metrics(metrics, _CMA_FIELDS, batch_ndim=1)


def _dp_result(hist: dict, var, **extra) -> dict:
    """The runners' result; ``var_est`` is zeros (shaped like ``mi``) where
    the history has none, as in the JAX package; ``extra`` entries of None
    are left out."""
    return {
        "ser": np.concatenate([hist["ser_const"], hist["ser_soft"]], axis=-2),
        "var_est": hist.get("var_est", np.zeros_like(hist["mi"])),
        "mi": hist["mi"],
        "var": var.cpu().numpy(),
        **{k: v for k, v in extra.items() if v is not None},
    }


# dims of each run constant's shared form; one more is its per-run form
_CONST_NDIM = {"lr": 0, "nu_sc": 0, "var": 1, "P": 1, "pow_mean": 0, "snr_lin": 0, "var_runs": 1}


def _frame0_keeper(steps: int, runs: int, device):
    """``frame0_losses``: ``keep(losses, count)`` copies a frame's per-step
    losses (steps, runs) into the device buffer ``keep.buf`` where the global
    step count ``count`` is 0, i.e. in frame 0, and leaves it as it is in
    every other frame: two small kernels a frame (the test and a ``where``
    into the buffer), on the device, so a CUDA graph of the frame keeps frame
    0's losses with no host sync. The buffer holds NaN until frame 0 has run
    (a call resumed past it)."""
    buf = torch.full((steps, runs), float("nan"), dtype=torch.float32, device=device)

    def keep(losses, count):
        with span("dp.losses"):
            torch.where(count == 0, losses.reshape(buf.shape), buf, out=buf)
    keep.buf = buf
    return keep


def _frame_kernel_train(cfg, amps, rc, *, runs, runs_batch, stream_bf16, stride_sym, crop, tx_of,
                        weight_fn, thresh, keep=None):
    """``use_pallas="frame"``: a frame's training is one kernel B launch for
    all runs (JAX ``_run_frame_kernel_experiment``), or one per group of
    ``runs_batch`` runs, with the run constants of ``_run_consts``; VAEflex's
    windows crop the eval streams to their central ``crop``
    (``crop_flex``). The eval takes all runs at once. ``keep``
    (``_frame0_keeper``) keeps frame 0's losses as B wrote them."""
    R = runs or 1
    rb = runs_batch or R
    if R % rb != 0:
        raise ValueError(f"runs_batch={rb} must divide runs={R}")

    def rows(name, sl):  # a run constant for the runs of one launch
        v = rc[name]
        return v[sl] if torch.is_tensor(v) and v.dim() > _CONST_NDIM[name] else v

    def train(params, opt, count, rx, tx, sigma):
        with span("dp.train"):
            parts = []
            for g in range(0, R, rb):
                sl = slice(g, g + rb)
                parts.append(vae_dp_frame_train(
                    params["w"][sl], params["h"][sl], {k: v[sl] for k, v in opt.items()}, rx[sl],
                    amps, rows("var", sl), rows("nu_sc", sl), rows("P", sl), rows("lr", sl), count,
                    thresh, bl_sym=cfg.batch_len, stride_sym=stride_sym, stream_bf16=stream_bf16))
            if len(parts) == 1:
                w, h, opt, losses, var_est, out_mb, dec_mb, eq_mb, mm_mb, s1_mb = parts[0]
            else:  # params and moments are runs-first, the streams (steps, runs, ...)
                cat = lambda i, dim: torch.cat([p[i] for p in parts], dim=dim)
                w, h = cat(0, 0), cat(1, 0)
                opt = {k: torch.cat([p[2][k] for p in parts]) for k in parts[0][2]}
                losses, var_est, out_mb, dec_mb, eq_mb, mm_mb, s1_mb = (
                    cat(i, 1) for i in range(3, 10))
            if keep is not None:
                keep(losses, count)
        with span("dp.eval"):
            streams = (a[..., crop] for a in (out_mb, dec_mb, eq_mb, mm_mb, s1_mb))
            out_mb, dec_mb, eq_mb, mm_mb, s1_mb = streams
            packed = _finish_vae_frame(losses, out_mb, var_est, tx_of(tx), amps, rc["P"], rc["var"],
                                       rc["nu_sc"], rc["pow_mean"], weight_fn, sigma, dec_mb, eq_mb,
                                       mm_mb, s1_mb)
        return {"w": w, "h": h}, opt, packed
    return train


def _step_train(cfg, const, amps, P, var, *, use_kernel, n_steps, stride_sym, crop, tx_of,
                weight_fn, thresh, keep=None):
    """The per-step modes (JAX's ``lax.scan`` over minibatches): each window
    is one step for all runs, then one Adam update. ``use_kernel`` (True):
    the step is kernel A, launched once for all runs on the window read in
    place (its plain version on a CPU tensor). False: autograd through the
    model and the ELBO (``jax.value_and_grad(loss_fn)``, train/dp.py:570-591)
    — not kernel A's closed form, so the two modes witness each other. The
    q and out streams, cropped to ``crop``, are evaluated time-major. Adam
    reads each step's scalars from ``adam_schedule``'s table by the step
    count on the device (``count``), so a CUDA graph of the frame replays
    every frame at its own steps. ``keep`` as in ``_frame_kernel_train``."""
    mb_len, hop = cfg.batch_len * cfg.sps, stride_sym * cfg.sps
    sched = adam_schedule(cfg.num_frames * n_steps, thresh, var.device)
    offsets = torch.arange(n_steps, device=var.device)

    def kernel_step(params, x):
        loss, var_est, gw, gh, q, out = vae_dp_loss_and_grad(
            params["w"], params["h"], x, amps, var, const.nu_sc, P)
        return loss, var_est, {"w": gw, "h": gh}, q, out

    def autograd_step(params, x):
        w, h = (params[k].detach().requires_grad_() for k in ("w", "h"))
        q, out = vae_le_dp_forward(w, x, amps, var, const.nu_sc, cfg.sps)
        loss, var_est = elbo_dp(q, x, h, amps, P)
        gw, gh = torch.autograd.grad(loss.sum(), (w, h))  # runs are independent
        return loss.detach(), var_est, {"w": gw, "h": gh}, q.detach(), out.detach()

    step = kernel_step if use_kernel else autograd_step

    def train(params, opt, count, rx, tx, sigma):
        with span("dp.train"):
            losses, var_est, q, out = [], [], [], []
            scalars = sched.index_select(0, count + offsets)  # (n_steps, 3): this frame's steps
            for m in range(n_steps):
                loss_m, var_m, grads, q_m, out_m = step(params, rx[..., m * hop : m * hop + mb_len])
                params, opt = adam_update(params, opt, grads, cfg.lr, scalars[m])
                losses.append(loss_m)
                var_est.append(var_m)
                q.append(q_m[..., crop])
                out.append(out_m[..., crop])
            losses, q, out = torch.stack(losses), torch.cat(q, -1), torch.cat(out, -1)
            var_est = torch.stack(var_est, -2)
            if keep is not None:
                keep(losses, count)
        with span("dp.eval"):
            packed = _finish_step_frame(losses, q, out, var_est, tx_of(tx), const, amps, P, var,
                                        weight_fn, sigma)
        return params, opt, packed
    return train


def _vae_carry(params: dict, shard: RunShard, device) -> tuple:
    """The VAE / VAEflex frame loop's carry: (params of ``shard``'s runs,
    Adam moments, global step count on the device), so the lr schedule and
    bias correction continue across frames, and a resume restores all three."""
    tail = {"w": 3, "h": 4}  # w (2, 4, M), h (2, 2, 2, M), with or without a runs axis
    params = {k: shard.take(v.expand((shard.runs,) + v.shape[-tail[k]:]).contiguous())
              for k, v in params.items()}
    return params, frame_opt_init(params), torch.zeros((1,), dtype=torch.int64, device=device)


def _run_vae_experiment(cfg, gen, var, draws, train, *, steps_per_frame, carry, thetas, runs,
                        shard, progress, ckpt, graph_opts, P_draw=None, snr_lin=None,
                        var_runs=None, keep=None):
    """The VAE / VAEflex frame loop for every mode from ``carry``
    (``_vae_carry``) over the frames' angles ``thetas``;
    ``train(params, opt, count, rx, tx, sigma) -> (params, opt, packed)``
    trains and evaluates one frame of this process's runs (``shard``'s; the
    default draws are drawn for every run, from ``ckpt.rng``, and cut to
    them); ``draws`` the caller's ``draws(frame, R)`` or None;
    ``graph_opts`` ``run_frame_loop``'s compiled / chunk_frames / timings;
    ``P_draw`` (R, n) every run's pmf of the default draws, ``snr_lin`` the
    channel's SNR of each of this process's runs, ``var_runs`` their
    demapper variance for the result; ``keep`` the ``_frame0_keeper`` that
    ``train`` fills, or None."""
    R = shard.count
    rng = ckpt.rng

    def frame_step(carry, theta, *drawn):
        params, opt, count = carry
        with span("dp.channel"):
            levels, noise = drawn or tuple(map(shard.take, gen.draws(rng, shard.runs, P_draw)))
            rx, tx, sigma = gen.physics(theta, levels, noise, snr_lin)
        params, opt, packed = train(params, opt, count, rx, tx, sigma)
        if runs is None:
            packed = packed[0]
        return (params, opt, count + steps_per_frame), packed

    (params, _, _), hist = run_frame_loop(
        frame_step, carry, (thetas,), _VAE_FIELDS,
        num_frames=cfg.num_frames, runs=None if runs is None else R, progress=progress, ckpt=ckpt,
        host_rows=None if rng is not None else (lambda f: draws(f, R)), **graph_opts)
    losses0 = None
    if keep is not None:  # (steps, R) -> (R, steps), one copy to the host a call
        losses0 = keep.buf.T.cpu().numpy()
    if runs is None:
        params = {k: v[0] for k, v in params.items()}
        losses0 = None if losses0 is None else losses0[0]
    return _dp_result(hist, var, params=params, var_runs=var_runs, frame0_losses=losses0)


def _default_draws(seed: int, device) -> torch.Generator:
    """The default draws' ``torch.Generator``, seeded with ``seed``: every
    frame draws in sequence from it (its state is part of a checkpoint, and
    a CUDA graph registers it)."""
    rng = torch.Generator(device=device)
    rng.manual_seed(seed)
    return rng


def _graph_opts(compiled: bool, chunk_frames: int, timings) -> dict:
    """``run_frame_loop``'s graph-mode options of a runner's call."""
    return dict(compiled=bool(compiled), chunk_frames=int(chunk_frames), timings=timings)


def _run_consts(cfg: DpConfig, const, var, runs, lr_vec, snr_vec, nu_vec, device) -> dict:
    """The VAE's run constants (JAX ``_run_frame_kernel_experiment``,
    train/dp.py:347-413): lr, nu_sc, the prior P, the demapper variance and
    the source power, each shared by all runs or, where ``lr_vec`` /
    ``snr_vec`` / ``nu_vec`` batch a sweep's lr / SNR / nu axis into the
    runs, per run; plus the channel's per-run pmf ``P_draw`` (nu) and linear
    SNR ``snr_lin`` (SNR), and ``var_runs`` (runs, 2) for the result. The
    per-run variance pow_mean(nu) / 10^(SNR/10) / 2 and SNR are folded in
    float64 on the host, as the scalar path folds them, so a constant vector
    gives the scalar path's bits."""
    P = torch.from_numpy(np.asarray(const.P, np.float32)).to(device)
    rc = dict(lr=cfg.lr, nu_sc=const.nu_sc, P=P, var=var, pow_mean=const.pow_mean, P_draw=None,
              snr_lin=None, var_runs=None)
    if lr_vec is None and snr_vec is None and nu_vec is None:
        return rc
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    if lr_vec is not None:
        lr_arr = np.asarray(lr_vec, np.float32)
        if lr_arr.shape != (runs,):
            raise ValueError(f"lr_vec must have shape ({runs},), got {lr_arr.shape}")
        rc["lr"] = f32(lr_arr)
    pm_runs = np.full((runs,), const.pow_mean, np.float64)
    if nu_vec is not None:
        nu_arr = np.asarray(nu_vec, np.float64).reshape(-1)
        if nu_arr.shape != (runs,):
            raise ValueError(f"nu_vec must have shape ({runs},), got {nu_arr.shape}")
        consts = [make_constellation(cfg.mod, float(v)) for v in nu_arr]
        rc["P_draw"] = np.stack([np.asarray(c.P, np.float32) for c in consts])
        rc["P"], rc["nu_sc"] = f32(rc["P_draw"]), f32([c.nu_sc for c in consts])
        pm_runs = np.asarray([c.pow_mean for c in consts], np.float64)
        rc["pow_mean"] = f32(pm_runs)
    if snr_vec is not None or nu_vec is not None:
        snr_db = np.full((runs,), cfg.snr_db, np.float32)
        if snr_vec is not None:
            snr_db = np.asarray(snr_vec, np.float32)
            if snr_db.shape != (runs,):
                raise ValueError(f"snr_vec must have shape ({runs},), got {snr_db.shape}")
            rc["snr_lin"] = f32(10.0 ** (np.float64(snr_db) / 10.0))
        rc["var_runs"] = ((pm_runs / 10.0 ** (np.float64(snr_db) / 10.0) / 2.0)[:, None]
                          * np.ones((1, 2))).astype(np.float32)
        rc["var"] = f32(rc["var_runs"])
    return rc


def _local_consts(rc: dict, shard: RunShard) -> dict:
    """``_run_consts`` of ``shard``'s runs: the rows of each per-run
    constant; ``P_draw`` stays whole (the default draws are drawn for every
    run)."""
    return {k: shard.take(v) if k in _CONST_NDIM and np.ndim(v) > _CONST_NDIM[k] else v
            for k, v in rc.items()}


def _vae_setup(loss_type, cfg, seed, device, params_init, use_pallas, draws, runs, runs_batch,
               stream_bf16, vecs, shard):
    """What both VAE runners share: the mode and option checks (JAX's
    refusals, train/dp.py:323-331, 565-566), then (device, n_frame,
    constellation, demapper var, simulator, amps, the run constants of
    ``shard``'s runs, params, the caller's draws or None, the default draws'
    generator or None) for frames of n_frame = (n_frame_max // batch_len) *
    batch_len symbols."""
    check_pallas_mode(loss_type, use_pallas)
    if use_pallas and (cfg.sps != 2 or cfg.m_est % 2 == 0):
        raise ValueError("use_pallas requires sps=2 and odd M_est")
    has_vec = any(v is not None for v in vecs)
    if use_pallas == "frame" and runs is None:
        if stream_bf16:
            raise ValueError("stream_bf16 needs the runs-batched kernel (set runs)")
        if has_vec:
            raise ValueError("lr_vec/snr_vec/nu_vec need the runs-batched kernel (set runs)")
    if use_pallas != "frame" and has_vec:
        raise ValueError('lr_vec/snr_vec/nu_vec need use_pallas="frame"')
    device = resolve_device(device)
    n_frame = cfg.n_frame_max // cfg.batch_len * cfg.batch_len
    const, var, gen, amps, _ = _setup(cfg, n_frame, device)
    rc = _local_consts(_run_consts(cfg, const, var, runs, *vecs, device), shard)
    params = params_init or {"w": butterfly_init(cfg.m_est, device), "h": dirac_taps_dp(cfg.m_est, device)}
    params = {k: torch.as_tensor(v, dtype=torch.float32).to(device) for k, v in params.items()}
    rng = _default_draws(seed, device) if draws is None else None
    return device, n_frame, const, var, gen, amps, rc, params, draws, rng


def _vae_runner(loss_type, cfg, seed, device, progress, runs, params_init, use_pallas, draws,
                runs_batch, stream_bf16, vecs, mesh, checkpoint, checkpoint_every, graph_opts,
                frame0_losses=False):
    """``train_vae_dp`` (batch_len windows back to back) and
    ``train_vae_flex_dp`` (windows every flex_step, central crop)."""
    with span("dp.setup"):
        shard = RunShard.of(mesh, runs)
        device, n_frame, const, var, gen, amps, rc, params, draws, rng = _vae_setup(
            loss_type, cfg, seed, device, params_init, use_pallas, draws, runs, runs_batch,
            stream_bf16, vecs, shard)
        bl = cfg.batch_len
        if loss_type == "VAE":
            n_steps = n_frame // bl
            kw = dict(stride_sym=bl, crop=slice(None), tx_of=lambda tx: tx,
                      weight_fn=BatchCutWeight(n_steps, bl, cfg.n_cut))
        else:
            fs = cfg.flex_step
            n_steps = (n_frame - bl) // fs
            m_max = n_steps * fs  # symbols of the recorded stream
            crop0 = (bl - fs) // 2
            kw = dict(stride_sym=fs, crop=slice(crop0, crop0 + fs),
                      tx_of=lambda tx: tx[..., bl // 2 : bl // 2 + m_max],
                      weight_fn=MarginWeight(m_max))
        kw["thresh"] = float(cfg.n_lrhalf) * n_steps
        kw["keep"] = _frame0_keeper(n_steps, shard.count, device) if frame0_losses else None
        if use_pallas == "frame":
            train = _frame_kernel_train(cfg, amps, rc, runs=None if runs is None else shard.count,
                                        runs_batch=runs_batch, stream_bf16=stream_bf16, **kw)
        else:
            train = _step_train(cfg, const, amps, rc["P"], var, use_kernel=use_pallas,
                                n_steps=n_steps, **kw)
        ckpt = shard.checkpoint(checkpoint, checkpoint_every, rng,
                                f"{loss_type} use_pallas={use_pallas!r}")
        carry = _vae_carry(params, shard, device)
        thetas = _frame_inputs(cfg, device)
    return _run_vae_experiment(cfg, gen, var, draws, train, steps_per_frame=n_steps, carry=carry,
                               thetas=thetas, runs=runs, shard=shard, progress=progress, ckpt=ckpt,
                               graph_opts=graph_opts, P_draw=rc["P_draw"], snr_lin=rc["snr_lin"],
                               var_runs=rc["var_runs"], keep=kw["keep"])


@run_sharding
def train_vae_dp(cfg: DpConfig, seed: int, device="cuda", progress: Progress = None,
                 runs: int | None = None, mesh=None, params_init=None, compiled: bool = False,
                 use_pallas=False, checkpoint=None, checkpoint_every: int = 0,
                 timings: dict | None = None, chunk_frames: int = 1, runs_batch: int | None = None,
                 stream_bf16: bool = False, lr_vec=None, snr_vec=None, nu_vec=None,
                 draws=None, frame0_losses: bool = False) -> dict:
    """VAE-LE butterfly, online frame training on the optical DP channel.

    ``use_pallas`` (``train/modes.py``; JAX's default False): ``"frame"``
    runs all of a frame's minibatch steps (incl. Adam) as one kernel B launch
    for all ``runs`` (``ops/frame_kernel.py``), or one per group of
    ``runs_batch`` runs (same results); ``True`` runs each minibatch of all
    runs as one kernel A launch (``ops/elbo_kernel.py``) followed by Adam;
    ``False`` takes each minibatch's gradient by autograd through the model
    and the ELBO. A kernel mode launches the CUDA kernel for a CUDA
    ``device`` and takes its plain version on the CPU. The kernel modes need
    sps = 2 and odd M.

    With ``"frame"`` and ``runs`` (JAX's runs-batched kernel path):
    ``lr_vec`` / ``snr_vec`` / ``nu_vec`` (runs,) give each run its own lr,
    SNR (channel noise and demapper variance) or PCS shaping nu (sampling
    pmf, demapper and KL constants, eval constants) — how a sweep batches a
    grid axis into the runs; ``stream_bf16`` stores kernel B's out / dec /
    eq streams as bfloat16 (training unchanged).

    The channel draws come from a ``torch.Generator`` seeded with ``seed``,
    or from ``draws(frame, runs) -> (levels (R, 4, n_conv), noise (R, 2, 2,
    sig_len))`` where given (how tests feed the JAX package's draws).

    ``checkpoint`` / ``checkpoint_every`` = K (JAX's contract): the state
    after every K-th frame (params, Adam moments and step count, histories,
    the generator's state) goes to the file ``checkpoint``, and a call that
    finds the file resumes from it, bit for bit as the uninterrupted run
    (``train/harness.py: Checkpoint``); a file of another mode raises
    ``ValueError``.

    ``compiled=True`` runs the experiment as one CUDA graph of a frame,
    captured once and replayed over every frame back to back, with one
    device-to-host copy of the histories at the end (``progress``
    unavailable, ``checkpoint`` ignored, as in JAX); ``chunk_frames=k``
    replays it k frames per chunk, one copy per chunk, ``progress`` per
    frame and the checkpoint saved at chunk ends (JAX's rule: once K frames
    have run since the last save). Both give the loop mode's results bit for
    bit (``train/harness.py``); on the CPU they run the same step eagerly.
    ``timings`` (a dict, compiled mode): "compile_s" (warm-up and capture)
    and "run_s" (the best of 3 replays of the whole experiment, each from
    the initial state and draws; the result is the last one's).

    ``mesh`` (``parallel.run_mesh``, or ``make_mesh_2d(n, 1)``; JAX's run
    sharding, ``train/batching.py``): the runs split over its ranks, one
    unit per run or per group of ``runs_batch``, on gcd(units, ranks) of
    them; each rank draws every run from ``seed`` and runs its share on its
    device (its kernels, graphs and checkpoint file in every mode above),
    and this process, rank 0, returns every run's result: the call without
    a mesh's. A split that uses one rank runs here, on that rank's device;
    ``runs=None`` ignores the mesh; a mesh with an sp axis, or anything but
    a ``Mesh``, raises ``ValueError``.

    ``frame0_losses=True`` also returns frame 0's per-step losses, as the
    training wrote them (kernel B's ``losses``, or each step's ELBO in the
    per-step modes): kept on the device by two small kernels a frame
    (span ``dp.losses``), also under graph replay, and copied to the host
    once a call; NaN where this call did not run frame 0 (a resume past it).
    Off, nothing of it runs.

    Returns {"ser" (..., 4, F), "mi" (..., 2, F), "var_est" (..., 2, F),
    "var" (2,), "params" {"w", "h"}} with a leading runs axis iff ``runs``,
    "var_runs" (runs, 2), the per-run demapper variance, whenever
    ``snr_vec`` or ``nu_vec`` is set, and "frame0_losses" (..., steps) with
    ``frame0_losses``.
    """
    return _vae_runner("VAE", cfg, seed, device, progress, runs, params_init, use_pallas, draws,
                       runs_batch, stream_bf16, (lr_vec, snr_vec, nu_vec), mesh, checkpoint,
                       checkpoint_every, _graph_opts(compiled, chunk_frames, timings),
                       frame0_losses)


@run_sharding
def train_vae_flex_dp(cfg: DpConfig, seed: int, device="cuda", progress: Progress = None,
                      runs: int | None = None, mesh=None, params_init=None, compiled: bool = False,
                      use_pallas=False, checkpoint=None, checkpoint_every: int = 0,
                      timings: dict | None = None, chunk_frames: int = 1,
                      runs_batch: int | None = None, stream_bf16: bool = False, lr_vec=None,
                      snr_vec=None, nu_vec=None, draws=None, frame0_losses: bool = False) -> dict:
    """VAEflex: overlapping sliding-window minibatches with a central crop
    (func_VAEflex_DP_MQAM_shaping.py:16-90, JAX ``train_vae_flex_dp``).

    Window m covers symbols [m * flex_step, m * flex_step + batch_len) of the
    frame; there are (n_frame - batch_len) // flex_step windows, and the
    central flex_step symbols of each, from (batch_len - flex_step) // 2 on,
    are the recorded stream, held against tx from batch_len // 2 on.
    ``use_pallas``: ``"frame"`` runs all windows (incl. Adam) as one kernel B
    launch with ``stride_sym = flex_step``; ``True`` runs each window of all
    runs as one kernel A launch; ``False`` takes each window's gradient by
    autograd. Arguments, draws, the graph modes, ``mesh``, ``frame0_losses``
    (its steps are the frame's windows) and returns as ``train_vae_dp``.
    """
    return _vae_runner("VAEflex", cfg, seed, device, progress, runs, params_init, use_pallas, draws,
                       runs_batch, stream_bf16, (lr_vec, snr_vec, nu_vec), mesh, checkpoint,
                       checkpoint_every, _graph_opts(compiled, chunk_frames, timings),
                       frame0_losses)


@run_sharding
def run_cma_dp(cfg: DpConfig, seed: int, device="cuda", progress: Progress = None,
               runs: int | None = None, mesh=None, taps_init=None, use_pallas=False,
               compiled: bool = False, checkpoint=None, checkpoint_every: int = 0,
               chunk_frames: int = 1, timings: dict | None = None, runs_batch: int | None = None,
               draws=None) -> dict:
    """CMA / CMAbatch / CMAflex baseline on the optical DP channel (``cfg.loss_type``).

    Per frame: adapt the taps online -> CPE -> sync -> constellation SER;
    then soft demapper -> sync -> posterior SER and MI. The lr halves every
    n_lrhalf frames (multiplicatively, unlike the VAE's one-time halving).

    ``use_pallas`` (``train/modes.py``): False runs the plain PyTorch
    equalizers (``models/cma.py``); True runs CMA's per-symbol recurrence as
    kernel C (``ops/cma_kernel.py``); "frame" runs CMAbatch/CMAflex as
    kernel D (``ops/cma_frame_kernel.py``). A kernel mode launches the CUDA
    kernel for a CUDA ``device`` and takes its plain version on the CPU.
    All ``runs`` go through one launch per frame, or one per group of
    ``runs_batch``. The draws come from a ``torch.Generator`` seeded with
    ``seed``, or from ``draws(frame, R)`` as in ``train_vae_dp``;
    ``checkpoint`` / ``checkpoint_every`` as there (the carry is the taps;
    each frame's lr follows from its index); ``compiled`` / ``chunk_frames``
    / ``timings`` as there (a graph reads each frame's lr from a device
    table by its frame counter); ``mesh`` as there.
    ``taps_init`` (2, 2, 2, M) or (runs, 2, 2, 2, M), numpy or torch.

    Returns {"ser" (..., 4, F), "mi" (..., 2, F), "var_est" (zeros,
    (..., 2, F)), "var" (2,), "taps" (..., 2, 2, 2, M)} with a leading runs
    axis iff ``runs``.
    """
    check_pallas_mode(cfg.loss_type, use_pallas)
    shard = RunShard.of(mesh, runs)
    step = cfg.batch_len if cfg.loss_type == "CMAbatch" else cfg.flex_step
    if use_pallas == "frame":
        equalize = lambda rx, h, lr: cma_chunked_frame(rx, cfg.R, h, lr, cfg.batch_len, step, cfg.sps)
    elif cfg.loss_type == "CMA":
        eq_fn = cma_dp_kernel if use_pallas else cma_dp
        equalize = lambda rx, h, lr: eq_fn(rx, cfg.R, h, lr, cfg.sps, True)
    elif cfg.loss_type == "CMAbatch":
        equalize = lambda rx, h, lr: cma_batch_dp(rx, cfg.R, h, lr, cfg.batch_len, cfg.sps, True)
    elif cfg.loss_type == "CMAflex":
        equalize = lambda rx, h, lr: cma_flex_dp(rx, cfg.R, h, lr, cfg.batch_len, step, cfg.sps, True)
    else:
        raise ValueError(f"unknown CMA variant {cfg.loss_type!r}")

    device = resolve_device(device)
    R = shard.count
    rb = runs_batch or R
    if R % rb != 0:
        raise ValueError(f"runs_batch={rb} must divide runs={R}")
    n_frame = cfg.n_frame_max
    n_eval = n_frame - 2 * cfg.n_cut  # symbols per frame after the edge cut
    const, var, gen, amps, P = _setup(cfg, n_frame, device)
    rng = _default_draws(seed, device) if draws is None else None
    h = dirac_taps_dp(cfg.m_est, device) if taps_init is None else taps_init
    if not isinstance(h, torch.Tensor):
        h = torch.from_numpy(np.array(h, np.float32))  # a copy: JAX arrays are read-only
    h = h.to(device, torch.float32)
    h = shard.take(h.expand((shard.runs,) + h.shape[-4:]).contiguous())
    weight_fn = MarginWeight(n_eval)
    lrs = (np.float32(cfg.lr) * 0.5 ** (np.arange(cfg.num_frames) // cfg.n_lrhalf)).astype(np.float32)

    def frame_step(h, theta, lr, *drawn):
        levels, noise = drawn or tuple(map(shard.take, gen.draws(rng, shard.runs)))
        rx, tx, sigma = gen.physics(theta, levels, noise)
        groups = [equalize(rx[g : g + rb], h[g : g + rb], lr) for g in range(0, R, rb)]
        out, h, e = (torch.cat(parts) for parts in zip(*groups))
        packed = _finish_cma_frame(out, e, tx, sigma, const, amps, P, var, cfg.n_cut, weight_fn)
        return h, packed if runs is not None else packed[0]

    ckpt = shard.checkpoint(checkpoint, checkpoint_every, rng,
                            f"{cfg.loss_type} use_pallas={use_pallas!r}")
    h, hist = run_frame_loop(
        frame_step, h, (_frame_inputs(cfg, device), torch.from_numpy(lrs).to(device)), _CMA_FIELDS,
        num_frames=cfg.num_frames, runs=None if runs is None else R, progress=progress, ckpt=ckpt,
        host_rows=None if rng is not None else (lambda f: draws(f, R)),
        **_graph_opts(compiled, chunk_frames, timings))
    return _dp_result(hist, var, taps=h if runs is not None else h[0])
