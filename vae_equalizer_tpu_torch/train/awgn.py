"""The AWGN experiments: VAE-LE (the reference's ``Eval_run_shaping_vaele``),
VAE-NN (``Eval_run_vaenn``) and CMA (``Eval_run_shaping_cma``).

Port of ``vae_equalizer_tpu/train/awgn.py: train_vae_le_awgn`` (with
``_run_epochs`` in loop mode, ``_siso_eval_pack`` and
``_run_siso_frame_experiment``), ``train_vae_nn_awgn`` (with
``_run_nn_frame_experiment``) and ``run_cma_awgn``. Semantics follow the
reference (func_VAELE_MQAM_shaping.py:235-324, func_VAENN_MQAM.py:215-297,
func_CMA_MQAM_shaping.py:201-256): every
epoch draws a fresh training frame of ``n_train`` symbols and trains its
``n_train // batch_len`` minibatches with AMSGrad; every ``epe`` epochs a
fresh ``n_valid``-symbol frame measures SER and MI of the posteriors (train
epoch k*epe, evaluate, train the remaining epe - 1 epochs).

VAE-LE modes (``use_pallas``, the JAX package's names):
  False    — autograd through ``vae_le_siso_forward`` + ``elbo_siso``;
  True     — kernel F (``ops/elbo_siso_kernel.py``) computes each
             minibatch's loss and gradients for all runs in one launch;
  "frame"  — kernel G (``ops/siso_frame_kernel.py``) trains the whole
             experiment for all runs in one launch (or one per group of
             ``runs_batch``), streaming out the parameters at the eval
             points; every epoch's channel data is generated up front and
             the evaluations run afterwards, batched over runs x evals.
VAE-NN modes: False (autograd through ``models/vae_nn.py: vae_nn_forward``
+ the uniform-prior ``elbo_siso``) and "frame" (kernel H,
``ops/nn_frame_kernel.py``, one launch for all runs); True raises, as in
JAX: there is no per-step VAE-NN kernel.
The CMA experiment has no gradient and one route: every epoch's channel
data is drawn up front, kernel I (``ops/cma_siso_kernel.py``) adapts the
taps over every epoch for all runs in one launch and streams out the taps
at the eval points, and the evaluations (frozen-taps FIR, CPE, sync, SER,
MI) run afterwards, batched over runs x evals.
A kernel mode launches the CUDA kernel for a CUDA ``device`` and takes its
plain version on the CPU. Every mode shares one AMSGrad (optax semantics,
``ops/siso_frame_kernel.py: amsgrad``). ``device`` defaults to the card;
``device="cpu"`` runs the plain versions. The loop modes and the CMA
experiment take JAX's ``checkpoint`` / ``checkpoint_every`` (``harness.py:
Checkpoint``); the VAE runners' frame mode refuses them, as in JAX.

``compiled=True`` (JAX's one-program experiment): a loop mode captures its
training epoch and its eval as two CUDA graphs (``harness.py:
StepGraphs``) and replays them over the experiment back to back, each
superstep [train epoch, eval, train x (epe - 1)], the trailing partial block
trained without an eval as the loop mode trains it, with one device-to-host
copy at the end: the loop mode's results bit for bit. The frame modes and
the CMA experiment are one program already and run as they do. ``timings``
(a dict): "compile_s" and "run_s" (the best of 3 whole experiments from the
same state and draws): for the loop modes under ``compiled``, the warm-up
and capture, then the replays; for the one-program experiments, the build
and a warm-up run, then the runs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..channels import channel_ir, make_awgn_simulator
from ..core import make_constellation, resolve_device
from ..metrics import (
    cpe_siso,
    find_shift_siso,
    find_shift_symb_siso,
    mutual_information_ambiguity,
    ser_const_siso,
    ser_q_siso,
)
from ..models import (
    cma_siso,
    dirac_taps_siso,
    elbo_siso,
    siso_fir_init,
    soft_demap_dp,
    vae_le_siso_forward,
)
from ..models.vae_nn import vae_nn_forward, vae_nn_init
from ..ops.cma_siso_kernel import cma_siso_experiment
from ..ops.elbo_siso_kernel import vae_siso_loss_and_grad
from ..ops.nn_frame_kernel import (
    flatten_nn_params,
    nn_frame_opt_init,
    nn_net,
    vae_nn_experiment_train,
    vae_nn_experiment_train_plain,
)
from ..ops.siso_frame_kernel import (
    amsgrad,
    amsgrad_schedule,
    siso_frame_opt_init,
    vae_siso_experiment_train,
)
from ..utils.config import AwgnCmaConfig, AwgnVaeLeConfig, AwgnVaeNnConfig
from .batching import RunShard, run_sharding
from .eval_utils import margin_weight, roll_time
from .harness import Checkpoint, Progress, StepGraphs, _leaves, _rebuild, table_rows

__all__ = ["run_cma_awgn", "train_vae_le_awgn", "train_vae_nn_awgn"]

_EVAL_NAMES = ("ser", "mi", "shift")
# frame mode: validation frames (runs x evals) per batched evaluation; at
# n_valid = 15,000 a batch of 100 holds ~0.1 GB of posteriors
_EVAL_BATCH = 100


def _setup(cfg, device, fixed_noise: bool = False):
    """Constellation (``cfg.nu``; uniform for the VAE-NN's config, which has
    none), the train / valid simulators, amps, P and the demapper variance
    10^(-SNR/10) of the SISO VAE-LE (awgn.py:361)."""
    const = make_constellation(cfg.mod, getattr(cfg, "nu", 0.0))
    h_up, m_orig = channel_ir(cfg.channel, cfg.sps)
    sims = {kind: make_awgn_simulator(const, cfg.snr_db, h_up, m_orig, n, cfg.sps,
                                      fixed_noise=fixed_noise, device=device)
            for kind, n in (("train", cfg.n_train), ("valid", cfg.n_valid))}
    amps = torch.from_numpy(const.amps).to(device)
    P = torch.from_numpy(np.asarray(const.P, np.float32)).to(device)
    return const, sims, amps, P, 10 ** (-cfg.snr_db / 10)


def _per_run(v, shard: RunShard, tail: int, device) -> torch.Tensor:
    """A parameter (numpy or torch, with or without a runs axis) as a
    contiguous float32 (R, *last ``tail`` dims) tensor on ``device`` of
    ``shard``'s R runs."""
    v = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, np.float32))
    v = v.to(device, torch.float32)
    return shard.take(v.expand((shard.runs,) + v.shape[-tail:]).contiguous())


def _drawn(sim, rng: torch.Generator, shard: RunShard) -> tuple:
    """A frame's default draws: drawn from ``rng`` for every run, as the
    call without a mesh draws them, and cut to ``shard``'s runs."""
    return tuple(map(shard.take, sim.draws(rng, shard.runs)))


def _siso_eval_pack(q, tx, n_valid: int, const, amps, P) -> torch.Tensor:
    """Shared posterior eval: sync -> roll -> masked SER + MI, packed (..., 3)."""
    shift = find_shift_siso(q, tx, 21, amps)
    q_r = roll_time(q, shift)
    w = margin_weight(n_valid, shift)
    ser = ser_q_siso(q_r, tx, const.num_lev, weight=w)
    mi = mutual_information_ambiguity(q_r, tx, amps, P, weight=w)
    return torch.stack([ser, mi, shift.to(torch.float32)], dim=-1)


def _evaluate(cfg, w, valid_draws, sim, const, amps, P, var) -> torch.Tensor:
    """Validation frames (levels, noise) (*b, ...) through the taps w (*b, 1, 2, M)."""
    rx, tx, _ = sim.physics(*valid_draws)
    q, _ = vae_le_siso_forward(w, rx, amps, const.amp_mean, var, cfg.sps)
    return _siso_eval_pack(q, tx, cfg.n_valid, const, amps, P)


def _run_epochs(cfg, epoch_step, eval_step, carry, R: int, progress: Progress,
                ckpt: Checkpoint, draws=None, compiled: bool = False, timings: dict | None = None):
    """JAX ``_run_epochs``: ``epoch_step(carry, epoch, *drawn) -> (carry, loss
    (R,))`` trains one epoch (``epoch`` the epoch counter on the device);
    after epoch k*epe, ``eval_step(carry, *drawn) -> (R, 3)`` evaluates.
    ``drawn`` is the caller's ``draws("train", epoch, R)`` / ``draws("valid",
    k, R)`` where given, else empty (the steps draw from ``ckpt.rng``).

    Loop mode: ``ckpt`` resumes from its file and saves after every K-th
    epoch, after that epoch's eval and ``progress`` (JAX's order): the train
    and valid draws share one generator, so its state is taken past the
    eval's draw. ``compiled``: both steps are captured as CUDA graphs and
    replayed in the loop mode's order (module docstring; ``progress`` and
    ``ckpt`` unused, ``timings`` filled), the caller's draws stacked up front
    and read by the counters. Returns (carry, packed (R, n_evals, 3))."""
    E, epe = cfg.num_epochs, cfg.epe
    n_evals = E // epe
    hist = {"packed": np.zeros((R, n_evals, len(_EVAL_NAMES)), np.float32)}
    start, carry = (0, carry) if compiled else ckpt.resume(carry, hist)
    leaves = [leaf.clone() for leaf in _leaves(carry)]
    static = _rebuild(carry, iter(leaves))
    dev = leaves[0].device
    e_t = torch.full((1,), start, dtype=torch.int64, device=dev)
    tables = {"train": (), "valid": ()}
    if compiled and draws is not None:
        for kind, n in (("train", E), ("valid", n_evals)):
            tables[kind] = tuple(torch.stack(c) for c in zip(*(draws(kind, i, R) for i in range(n))))
    buf: dict = {}

    def train(epoch=None):
        drawn = draws("train", epoch, R) if epoch is not None and draws else table_rows(
            tables["train"], e_t)
        new, buf["loss"] = epoch_step(static, e_t, *drawn)
        for s, v in zip(leaves, _leaves(new)):
            s.copy_(v)
        e_t.add_(1)

    def evaluate(i=None):
        slot = torch.div(e_t - 1, epe, rounding_mode="floor")  # eval k follows epoch k*epe
        drawn = draws("valid", i, R) if i is not None and draws else table_rows(tables["valid"], slot)
        packed = eval_step(static, *drawn)
        if "hist" not in buf:
            buf["hist"] = torch.zeros((n_evals,) + tuple(packed.shape), dtype=torch.float32,
                                      device=dev)
        buf["hist"].index_copy_(0, slot, packed[None])

    def evals_after(epoch: int) -> bool:
        return epoch % epe == 0 and epoch // epe < n_evals

    if not compiled:
        for epoch in range(start, E):
            train(epoch)
            if evals_after(epoch):
                i = epoch // epe
                evaluate(i)
                hist["packed"][:, i] = buf["hist"][i].cpu().numpy()  # one copy per eval
                if progress:
                    progress(epoch, {"loss": buf["loss"].cpu().numpy(),
                                     **{n: hist["packed"][:, i, j] for j, n in enumerate(_EVAL_NAMES)}})
            if ckpt.due(epoch + 1, E):
                ckpt.save(epoch + 1, static, hist)
        return static, hist["packed"]

    graphs = StepGraphs({"train": train, "eval": evaluate}, leaves + [e_t], ckpt.rng, dev, graph=True)
    graphs.build(timings)

    def run_all():
        for epoch in range(E):
            graphs.run("train")
            if evals_after(epoch):
                graphs.run("eval")

    graphs.timed(run_all, timings)
    return static, buf["hist"].movedim(0, 1).cpu().numpy()  # one device-to-host copy


def _vae_le_epoch(cfg, step_fn, sim, rng, shard: RunShard):
    """One VAE-LE epoch of the loop modes: a training frame (the caller's
    draws, or drawn from ``rng`` for ``shard``'s runs) and its minibatch
    steps (``step_fn(w, h, x) -> (loss, gw, gh)`` + AMSGrad at the global
    step in the carry, its bias corrections read from ``amsgrad_schedule``'s
    table by that count on the device) over the carry ({"w", "h"}, AMSGrad
    moments, step)."""
    n_batches = cfg.n_train // cfg.batch_len
    mb_len = cfg.batch_len * cfg.sps
    dev = sim.device
    sched = amsgrad_schedule(cfg.num_epochs * n_batches, dev)
    offsets = torch.arange(n_batches, device=dev)

    def epoch_step(carry, epoch, *drawn):
        params, opt, step = carry
        w, h = params["w"], params["h"]
        mw, vw, xw, mh, vh, xh = (opt[k] for k in ("mw", "vw", "xw", "mh", "vh", "xh"))
        rx, _, _ = sim.physics(*(drawn or _drawn(sim, rng, shard)))
        scalars = sched.index_select(0, step + offsets)  # (n_batches, 2): this epoch's steps
        for b in range(n_batches):
            loss, gw, gh = step_fn(w, h, rx[..., b * mb_len : (b + 1) * mb_len].contiguous())
            w, mw, vw, xw = amsgrad(w, mw, vw, xw, gw, cfg.lr, scalars[b])
            h, mh, vh, xh = amsgrad(h, mh, vh, xh, gh, cfg.lr, scalars[b])
        opt = dict(zip(("mw", "vw", "xw", "mh", "vh", "xh"), (mw, vw, xw, mh, vh, xh)))
        return ({"w": w, "h": h}, opt, step + n_batches), loss
    return epoch_step


def _one_program(run, rng, device, timings: dict | None):
    """``run()`` once, or with ``timings`` timed as JAX times a one-program
    experiment (``StepGraphs`` with one step and no graph): "compile_s" the
    kernels' build and a warm-up run (its draws and launches put back),
    "run_s" the best of 3 runs, each from the same generator state; returns
    the last run's result."""
    if timings is None:
        return run()
    program = StepGraphs({"run": run}, [], rng, device, graph=False)
    program.build(timings)
    return program.timed(run, timings)


def _frame_train_data(sim, draws, R: int, n_epochs: int) -> torch.Tensor:
    """Every epoch's training frame for all runs, up front: rx (R, E, 2, sps n_train)."""
    lev, noi = zip(*(draws("train", e, R) for e in range(n_epochs)))
    return sim.physics(torch.stack(lev, dim=1), torch.stack(noi, dim=1))[0]


def _frame_train(cfg, params, rx_epochs, amps, P, var, amp_mean: float, rb: int):
    """Kernel G over groups of ``rb`` runs: (params, w_evals (n_evals + 1, R, 1, 2, M))."""
    outs = []
    for g in range(0, rx_epochs.shape[0], rb):
        p = {k: v[g : g + rb].contiguous() for k, v in params.items()}
        outs.append(vae_siso_experiment_train(
            p["w"], p["h"], siso_frame_opt_init(p), rx_epochs[g : g + rb], amps, amp_mean, var, P,
            cfg.lr, bl_sym=cfg.batch_len, n_batches=cfg.n_train // cfg.batch_len, epe=cfg.epe))
    params = {"w": torch.cat([o[0] for o in outs]), "h": torch.cat([o[1] for o in outs])}
    return params, torch.cat([o[4] for o in outs], dim=1)


def _batched_evals(n_evals: int, R: int, draws, evaluate) -> np.ndarray:
    """The n_evals evaluations over streamed snapshots, batched over runs and
    chunks of evals: ``evaluate(slots: slice, valid_draws (chunk, R, ...))
    -> (chunk, R, 3)``; returns packed (R, n_evals, 3)."""
    chunk = max(1, _EVAL_BATCH // R)
    packed = []
    for i0 in range(0, n_evals, chunk):
        idx = range(i0, min(i0 + chunk, n_evals))
        lev, noi = zip(*(draws("valid", i, R) for i in idx))
        packed.append(evaluate(slice(idx.start, idx.stop), (torch.stack(lev), torch.stack(noi))))
    return torch.cat(packed).movedim(0, 1).cpu().numpy()  # one device-to-host copy


def _frame_evals(cfg, w_ev, draws, sim, const, amps, P, var) -> np.ndarray:
    """VAE-LE frame mode's evaluations over the taps snapshots w_ev (n_evals + 1, R, 1, 2, M)."""
    return _batched_evals(cfg.num_epochs // cfg.epe, w_ev.shape[1], draws,
                          lambda sl, vd: _evaluate(cfg, w_ev[sl], vd, sim, const, amps, P, var))


def _default_draws(sims, seed: int, device, shard: RunShard):
    """(draws, rng): the train and valid draws in sequence from one
    ``torch.Generator`` seeded with ``seed`` (its state is part of a
    checkpoint, and a CUDA graph registers it), for ``shard``'s runs."""
    rng = torch.Generator(device=device)
    rng.manual_seed(seed)
    return (lambda kind, index, R: _drawn(sims[kind], rng, shard)), rng


def _frame_refuses_checkpoint(use_pallas, checkpoint) -> None:
    if use_pallas == "frame" and checkpoint:
        raise ValueError('use_pallas="frame" runs the whole experiment in one call; '
                         "checkpointing is unavailable")


@run_sharding
def train_vae_le_awgn(cfg: AwgnVaeLeConfig, seed: int, device="cuda", progress: Progress = None,
                      runs: int | None = None, mesh=None, params_init=None, compiled: bool = False,
                      use_pallas=False, checkpoint=None, checkpoint_every: int = 0,
                      timings: dict | None = None, runs_batch: int | None = None,
                      draws=None) -> dict:
    """VAE-LE training on the AWGN ISI channel (use_pallas: see the module docstring).

    The parameters come in JAX's order (``train/awgn.py: train_vae_le_awgn``)
    with ``device`` inserted third and the port's own ``draws`` last, so a
    positional call written for JAX binds the same arguments.

    The channel draws come from a ``torch.Generator`` seeded with ``seed``,
    or from ``draws(kind, index, R) -> (levels (R, 2, n_conv), noise
    (R, 2, sig_len))`` where given, with kind "train" (index = epoch) or
    "valid" (index = eval) — how tests feed the JAX package's draws.
    ``params_init`` {"w" (R?, 1, 2, M), "h" (R?, 2, M)}, numpy or torch.
    ``runs_batch`` (frame mode): runs per kernel G launch (default: all).
    ``progress(epoch, metrics)`` is called after each loop-mode eval.
    ``checkpoint`` / ``checkpoint_every`` = K (loop modes, JAX's contract):
    the state after every K-th epoch (w, h, the AMSGrad moments and step,
    the evals so far and the generator's state, taken after the epoch's
    eval) goes to the file ``checkpoint``, and a call that finds the file
    resumes from it, bit for bit as the uninterrupted run; frame mode
    refuses a checkpoint with JAX's ``ValueError``. ``compiled`` /
    ``timings``: the module docstring (the loop modes replay CUDA graphs, the
    frame mode is one program). ``mesh``: the runs split over its ranks
    (``train/batching.py``), as ``train/dp.py: train_vae_dp`` describes.

    Returns {"ser" (..., n_evals), "mi" (..., n_evals), "params" {"w"
    (..., 1, 2, M), "h" (..., 2, M)}} with a leading runs axis iff ``runs``.
    """
    if use_pallas not in (False, True, "frame"):
        raise ValueError(f"use_pallas={use_pallas!r}: expected False, True or 'frame'")
    if use_pallas and (cfg.sps != 2 or cfg.m_est % 2 == 0):
        raise ValueError("use_pallas requires sps=2 and odd M_est")
    _frame_refuses_checkpoint(use_pallas, checkpoint)

    device = resolve_device(device)
    shard = RunShard.of(mesh, runs)
    R = shard.count
    const, sims, amps, P, var = _setup(cfg, device)
    caller_draws, rng = draws, None
    if draws is None:
        draws, rng = _default_draws(sims, seed, device, shard)
    params = params_init or {"w": siso_fir_init(cfg.m_est), "h": dirac_taps_siso(cfg.m_est)}
    params = {"w": _per_run(params["w"], shard, 3, device),
              "h": _per_run(params["h"], shard, 2, device)}

    if use_pallas == "frame":
        rb = runs_batch or R
        if R % rb != 0:
            raise ValueError(f"runs_batch={rb} must divide runs={R}")

        def experiment():
            rx_epochs = _frame_train_data(sims["train"], draws, R, cfg.num_epochs)
            p, w_ev = _frame_train(cfg, params, rx_epochs, amps, P, var, const.amp_mean, rb)
            return p, _frame_evals(cfg, w_ev, draws, sims["valid"], const, amps, P, var)

        params, packed = _one_program(experiment, rng, device, timings)
    else:
        if use_pallas:
            def step_fn(w, h, x):
                return vae_siso_loss_and_grad(w, h, x, amps, const.amp_mean, var, P)[:3]
        else:
            def step_fn(w, h, x):
                w_, h_ = w.detach().requires_grad_(), h.detach().requires_grad_()
                q, _ = vae_le_siso_forward(w_, x, amps, const.amp_mean, var, cfg.sps)
                loss = elbo_siso(q, x, h_, amps, P)  # (R,): runs are independent
                gw, gh = torch.autograd.grad(loss.sum(), (w_, h_))
                return loss.detach(), gw, gh
        ckpt = shard.checkpoint(checkpoint, checkpoint_every, rng,
                                f"VAE-LE use_pallas={use_pallas!r}")
        step0 = torch.zeros((1,), dtype=torch.int64, device=device)
        (params, _, _), packed = _run_epochs(
            cfg, _vae_le_epoch(cfg, step_fn, sims["train"], rng, shard),
            lambda c, *drawn: _evaluate(cfg, c[0]["w"], drawn or _drawn(sims["valid"], rng, shard),
                                        sims["valid"], const, amps, P, var),
            (params, siso_frame_opt_init(params), step0), R, progress, ckpt, caller_draws, compiled,
            timings)

    if runs is None:
        packed = packed[0]
        params = {k: v[0] for k, v in params.items()}
    return {"ser": packed[..., 0], "mi": packed[..., 1], "params": params}


def _nn_evaluate(cfg, net, rs, valid_draws, sim, const, amps, P) -> torch.Tensor:
    """Validation frames (*b, ...) through the CNN (parameters with leading
    dims *b); Net_BN uses the running statistics rs (*b, C, 2)."""
    rx, tx, _ = sim.physics(*valid_draws)
    with torch.no_grad():
        if cfg.batchnorm:
            state = {"mean": rs[..., 0], "var": rs[..., 1], "momentum": 0.1}
            q, _ = vae_nn_forward(net, rx, cfg.sps, state=state, train=False)
        else:
            q = vae_nn_forward(net, rx, cfg.sps)
        return _siso_eval_pack(q, tx, cfg.n_valid, const, amps, P)


@run_sharding
def train_vae_nn_awgn(cfg: AwgnVaeNnConfig, seed: int, device="cuda", progress: Progress = None,
                      runs: int | None = None, mesh=None, compiled: bool = False, use_pallas=False,
                      checkpoint=None, checkpoint_every: int = 0, timings: dict | None = None,
                      params_init=None, draws=None) -> dict:
    """VAE-NN (Net, or Net_BN with ``cfg.batchnorm``) training on the AWGN ISI
    channel, uniform constellation, fixed-noise convention, uniform-prior
    ELBO (use_pallas: False or "frame", see the module docstring). The
    parameters come in JAX's order with ``device`` inserted third and the
    port's own ``params_init`` and ``draws`` last.

    Draws as in ``train_vae_le_awgn``. The filters are Xavier-uniform from a
    ``torch.Generator`` seeded with ``seed`` (one start shared by all runs,
    as the JAX loop broadcasts one init), or ``params_init`` {"net": {"w1",
    "b1", "w2", "b2"[, "bn_scale", "bn_bias"]}, "h" (R?, 2, M)[, "bn":
    {"mean", "var", "momentum"}]}, numpy or torch (``utils/convert.py:
    nn_params_from_jax``). ``progress(epoch, metrics)`` is called after each
    loop-mode eval. ``checkpoint`` / ``checkpoint_every`` as in
    ``train_vae_le_awgn`` (the loop mode's carry: W1', W2', h, the BN
    parameters and running statistics, the AMSGrad moments; the step
    follows from the epoch); ``compiled`` / ``timings`` / ``mesh`` as there.

    Returns {"ser" (..., n_evals), "mi" (..., n_evals), "params" {"net",
    "h"[, "bn"]}} with a leading runs axis iff ``runs``.
    """
    if use_pallas is True:
        raise ValueError("VAE-NN has no per-step kernel mode; use use_pallas='frame'")
    if use_pallas not in (False, "frame"):
        raise ValueError(f"use_pallas={use_pallas!r}: expected False or 'frame'")
    if use_pallas == "frame" and (cfg.sps != 2 or cfg.m_est % 2 == 0 or cfg.kernel_2 != 3):
        raise ValueError('use_pallas="frame" requires sps=2, odd m_est and kernel_2=3')
    _frame_refuses_checkpoint(use_pallas, checkpoint)

    device = resolve_device(device)
    shard = RunShard.of(mesh, runs)
    R = shard.count
    const, sims, amps, P, _ = _setup(cfg, device, fixed_noise=True)
    caller_draws, rng = draws, None
    if draws is None:
        draws, rng = _default_draws(sims, seed, device, shard)
    if params_init is None:
        gen = torch.Generator()
        gen.manual_seed(seed ^ 0x5EED)
        net, bn_state = vae_nn_init(gen, cfg.kernel_1, cfg.kernel_2, const.num_lev, cfg.batchnorm)
        params_init = {"net": net, "h": dirac_taps_siso(cfg.m_est)}
        if cfg.batchnorm:
            params_init["bn"] = bn_state

    net0 = {k: _per_run(v, shard, 3 if k[0] == "w" else 1, device)
            for k, v in params_init["net"].items()}
    w1f, w2f = (t.contiguous() for t in flatten_nn_params(net0))
    h = _per_run(params_init["h"], shard, 2, device)
    ch, k1 = w1f.shape[-2], cfg.kernel_1
    bn = None
    if cfg.batchnorm:
        st = params_init["bn"]
        momentum = float(st["momentum"])
        bn = (torch.stack([net0["bn_scale"], net0["bn_bias"]], dim=-1),
              torch.stack([_per_run(st["mean"], shard, 1, device),
                           _per_run(st["var"], shard, 1, device)], dim=-1))
    else:
        momentum = 0.1
    opt = nn_frame_opt_init(w1f, w2f, h, None if bn is None else bn[0])
    n_batches = cfg.n_train // cfg.batch_len
    n_evals = cfg.num_epochs // cfg.epe
    kw = dict(bl_sym=cfg.batch_len, n_batches=n_batches, k1=k1)

    if use_pallas == "frame":
        def experiment():
            rx_epochs = _frame_train_data(sims["train"], draws, R, cfg.num_epochs)
            *out, _, _, w1_ev, w2_ev, _, bnp_ev, rs_ev = vae_nn_experiment_train(
                w1f, w2f, h, opt, rx_epochs, amps, cfg.lr, bn, momentum, epe=cfg.epe, **kw)
            return out, _batched_evals(n_evals, R, draws, lambda sl, vd: _nn_evaluate(
                cfg, nn_net(w1_ev[sl], w2_ev[sl], bnp_ev[sl], k1, cfg.batchnorm), rs_ev[sl], vd,
                sims["valid"], const, amps, P))

        (w1f, w2f, h, bnp, rs), packed = _one_program(experiment, rng, device, timings)
    else:
        bnp, rs = bn if bn is not None else (w1f.new_zeros((R, ch, 2)),) * 2
        sched = amsgrad_schedule(cfg.num_epochs * n_batches, device)
        offsets = torch.arange(n_batches, device=device)

        def epoch_step(carry, epoch, *drawn):
            w1f, w2f, h, bnp, rs, opt = carry
            rx, _, _ = sims["train"].physics(*(drawn or _drawn(sims["train"], rng, shard)))
            w1f, w2f, h, bnp, rs, opt, losses, *_ = vae_nn_experiment_train_plain(
                w1f, w2f, h, opt, rx[:, None], amps, cfg.lr, (bnp, rs) if bn is not None else None,
                momentum, epe=1, bias=sched.index_select(0, epoch * n_batches + offsets), **kw)
            return (w1f, w2f, h, bnp, rs, opt), losses[-1]

        def eval_step(carry, *drawn):
            w1f, w2f, _, bnp, rs, _ = carry
            return _nn_evaluate(cfg, nn_net(w1f, w2f, bnp, k1, cfg.batchnorm), rs,
                                drawn or _drawn(sims["valid"], rng, shard), sims["valid"], const,
                                amps, P)

        ckpt = shard.checkpoint(checkpoint, checkpoint_every, rng,
                                f"VAE-NN batchnorm={cfg.batchnorm} use_pallas={use_pallas!r}")
        (w1f, w2f, h, bnp, rs, _), packed = _run_epochs(
            cfg, epoch_step, eval_step, (w1f, w2f, h, bnp, rs, opt), R, progress, ckpt,
            caller_draws, compiled, timings)

    params = {"net": nn_net(w1f, w2f, bnp, k1, cfg.batchnorm), "h": h}
    if cfg.batchnorm:
        params["bn"] = {"mean": rs[..., 0], "var": rs[..., 1], "momentum": momentum}
    if runs is None:
        packed = packed[0]
        first = lambda v: v[0] if isinstance(v, torch.Tensor) else v  # noqa: E731
        params = {k: {kk: first(vv) for kk, vv in v.items()} if isinstance(v, dict) else v[0]
                  for k, v in params.items()}
    return {"ser": packed[..., 0], "mi": packed[..., 1], "params": params}


def _cma_evaluate(cfg, h, valid_draws, sim, amps, P, var_q, nu_sc: float) -> torch.Tensor:
    """Validation frames (*b, ...) through the frozen taps h (*b, 2, M): CPE,
    sync, the masked constellation SER and the MI of the soft demapper's
    posteriors on the synchronized output (awgn.py:660-671), packed (*b, 3)."""
    rx, tx, _ = sim.physics(*valid_draws)
    out = cpe_siso(cma_siso(rx, cfg.R, h, cfg.lr, cfg.sps, update=False)[0])
    shift = find_shift_symb_siso(out, tx, 21)
    out_r = roll_time(out, shift)
    w = margin_weight(cfg.n_valid, shift)
    ser = ser_const_siso(out_r, tx, amps, weight=w)
    q = soft_demap_dp(out_r.unsqueeze(-3), amps, var_q, nu_sc)[..., 0, :, :]
    mi = mutual_information_ambiguity(q, tx, amps, P, weight=w)
    return torch.stack([ser, mi, shift.to(torch.float32)], dim=-1)


def _cma_train(cfg, rx_epochs, h0, ckpt: Checkpoint):
    """Kernel I over every epoch: one launch, or with a checkpoint one launch
    per segment, the taps carried from one to the next and the losses and
    eval snapshots joined. A segment ends at each save point rounded up to a
    multiple of epe, so every segment starts on an eval slot and each launch
    computes what the whole launch computes for its epochs: the rounding
    moves when the state file is written (next epoch, taps, losses and
    snapshots so far), never what the run computes. Returns (taps, h_ev
    (n_evals, R, 2, M), loss (R, E))."""
    n_epochs, epe = cfg.num_epochs, cfg.epe
    ends = {n_epochs}
    if ckpt.path and ckpt.every:
        ends |= {min(n_epochs, -(-s // epe) * epe) for s in range(ckpt.every, n_epochs, ckpt.every)}
    R, dev = h0.shape[0], h0.device
    hist = {"loss": np.zeros((R, n_epochs), np.float32),
            "h_ev": np.zeros((n_epochs // epe, R, 2, cfg.m_est), np.float32)}
    e0, taps = ckpt.resume(h0, hist)
    h_ev = [torch.from_numpy(hist["h_ev"][: e0 // epe]).to(dev)]
    loss = [torch.from_numpy(hist["loss"][:, :e0]).to(dev)]
    for e1 in sorted(e for e in ends if e > e0):
        taps, h_ev_s, loss_s = cma_siso_experiment(rx_epochs[:, e0:e1].contiguous(), taps, cfg.R,
                                                   cfg.lr, cfg.sps, epe)
        h_ev.append(h_ev_s)
        loss.append(loss_s)
        if e1 < n_epochs:
            hist["h_ev"][: e1 // epe] = torch.cat(h_ev).cpu().numpy()
            hist["loss"][:, :e1] = torch.cat(loss, dim=1).cpu().numpy()
            ckpt.save(e1, taps, hist)
        e0 = e1
    return taps, torch.cat(h_ev), torch.cat(loss, dim=1)


@run_sharding
def run_cma_awgn(cfg: AwgnCmaConfig, seed: int, device="cuda", progress: Progress = None,
                 runs: int | None = None, mesh=None, compiled: bool = False, checkpoint=None,
                 checkpoint_every: int = 0, timings: dict | None = None, draws=None) -> dict:
    """CMA baseline on the AWGN ISI channel (no autograd): per-epoch tap
    adaptation on fresh data from the Dirac taps, evaluation on frozen taps
    after Viterbi-Viterbi CPE (func_CMA_MQAM_shaping.py:201-256), and the MI
    of the soft demapper's posteriors on the CPE output (a capability the
    reference lacks for SISO CMA, as in JAX).

    The parameters come in JAX's order (``train/awgn.py: run_cma_awgn``) with
    ``device`` inserted third and the port's own ``draws`` last. Draws as in
    ``train_vae_le_awgn``. Training is one kernel I launch for all runs
    (its plain version on the CPU); ``progress(epoch, metrics)`` is called
    for each eval epoch after the evaluations, with that epoch's mean |e| as
    "loss". ``checkpoint`` / ``checkpoint_every`` = K: kernel I runs in
    segments, saving the state at the end of each (``_cma_train``), and a
    call that finds the file resumes from it, bit for bit as the
    uninterrupted run; every epoch's data is drawn up front from ``seed`` on
    each call, so the file needs no generator state. ``compiled=True`` runs
    the same one-launch experiment (bit for bit; ``progress`` unavailable
    and ``checkpoint`` ignored, as in JAX); ``timings`` (a dict, where the
    experiment is one program: compiled, or without a checkpoint) as in
    ``train_vae_le_awgn``'s frame mode; ``mesh`` as there (each rank runs
    kernel I on its runs; the file holds every run's).

    Returns {"ser" (..., n_evals), "mi" (..., n_evals), "taps" (..., 2, M)}
    with a leading runs axis iff ``runs``.
    """
    device = resolve_device(device)
    shard = RunShard.of(mesh, runs)
    R = shard.count
    const, sims, amps, P, var = _setup(cfg, device)
    rng = None
    if draws is None:
        draws, rng = _default_draws(sims, seed, device, shard)
    var_q = torch.full((1,), var, dtype=torch.float32, device=device)
    n_evals = cfg.num_epochs // cfg.epe
    ckpt = Checkpoint() if compiled else shard.checkpoint(checkpoint, checkpoint_every,
                                                          ident="CMA-AWGN", hist_axes={"h_ev": 1})
    h0 = _per_run(dirac_taps_siso(cfg.m_est), shard, 2, device)

    def experiment():
        rx_epochs = _frame_train_data(sims["train"], draws, R, cfg.num_epochs)
        taps, h_ev, loss = _cma_train(cfg, rx_epochs, h0, ckpt)
        return taps, loss, _batched_evals(n_evals, R, draws, lambda sl, vd: _cma_evaluate(
            cfg, h_ev[sl], vd, sims["valid"], amps, P, var_q, const.nu_sc))

    taps, loss, packed = _one_program(experiment, rng, device, None if ckpt.path else timings)
    loss = loss.cpu().numpy()
    if runs is None:
        packed, taps, loss = packed[0], taps[0], loss[0]
    if progress and not compiled:
        for i in range(n_evals):
            progress(i * cfg.epe, {"loss": loss[..., i * cfg.epe],
                                   **{n: packed[..., i, j] for j, n in enumerate(_EVAL_NAMES)}})
    return {"ser": packed[..., 0], "mi": packed[..., 1], "taps": taps}
