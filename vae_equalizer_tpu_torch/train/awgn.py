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
``device="cpu"`` runs the plain versions.
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
from ..ops.siso_frame_kernel import amsgrad, siso_frame_opt_init, vae_siso_experiment_train
from ..utils.config import AwgnCmaConfig, AwgnVaeLeConfig, AwgnVaeNnConfig
from .eval_utils import margin_weight, roll_time
from .harness import Progress

__all__ = ["run_cma_awgn", "train_vae_le_awgn", "train_vae_nn_awgn"]

_EVAL_NAMES = ("ser", "mi", "shift")
# frame mode: validation frames (runs x evals) per batched evaluation; at
# n_valid = 15,000 a batch of 100 holds ~0.1 GB of posteriors
_EVAL_BATCH = 100
_DEFERRED = "not ported yet (ROADMAP.md, queue 1: 'Deferred train_vae_le_awgn options')"
_DEFERRED_NN = "not ported yet (ROADMAP.md, queue 1: 'Deferred train_vae_nn_awgn options')"
_DEFERRED_CMA = "not ported yet (ROADMAP.md, queue 1: 'Deferred run_cma_awgn options')"


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


def _per_run(v, R: int, tail: int, device) -> torch.Tensor:
    """A parameter (numpy or torch, with or without a runs axis) as a
    contiguous float32 (R, *last ``tail`` dims) tensor on ``device``."""
    v = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, np.float32))
    v = v.to(device, torch.float32)
    return v.expand((R,) + v.shape[-tail:]).contiguous()


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


def _run_epochs(cfg, step_fn, params, draws, sims, const, amps, P, var, R: int,
                progress: Progress) -> tuple[dict, np.ndarray]:
    """Loop mode: per epoch a training frame and its minibatch steps
    (``step_fn(w, h, x) -> (loss, gw, gh)`` + AMSGrad with a global step
    count); after epoch k*epe an evaluation. Returns (params, packed
    (R, n_evals, 3))."""
    n_evals = cfg.num_epochs // cfg.epe
    n_batches = cfg.n_train // cfg.batch_len
    mb_len = cfg.batch_len * cfg.sps
    w, h = params["w"], params["h"]
    opt = siso_frame_opt_init(params)
    mw, vw, xw, mh, vh, xh = (opt[k] for k in ("mw", "vw", "xw", "mh", "vh", "xh"))
    packed = np.zeros((R, n_evals, len(_EVAL_NAMES)), np.float32)
    step = 0
    for epoch in range(cfg.num_epochs):
        rx, _, _ = sims["train"].physics(*draws("train", epoch, R))
        for b in range(n_batches):
            loss, gw, gh = step_fn(w, h, rx[..., b * mb_len : (b + 1) * mb_len].contiguous())
            w, mw, vw, xw = amsgrad(w, mw, vw, xw, gw, cfg.lr, step)
            h, mh, vh, xh = amsgrad(h, mh, vh, xh, gh, cfg.lr, step)
            step += 1
        if epoch % cfg.epe == 0 and epoch // cfg.epe < n_evals:
            i = epoch // cfg.epe
            packed[:, i] = _evaluate(cfg, w, draws("valid", i, R), sims["valid"], const, amps, P,
                                     var).cpu().numpy()  # one device-to-host copy per eval
            if progress:
                progress(epoch, {"loss": loss.cpu().numpy(),
                                 **{n: packed[:, i, j] for j, n in enumerate(_EVAL_NAMES)}})
    return {"w": w, "h": h}, packed


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


def _default_draws(sims, seed: int, device):
    rng = torch.Generator(device=device)
    rng.manual_seed(seed)
    return lambda kind, index, R: sims[kind].draws(rng, R)


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

    Returns {"ser" (..., n_evals), "mi" (..., n_evals), "params" {"w"
    (..., 1, 2, M), "h" (..., 2, M)}} with a leading runs axis iff ``runs``.
    """
    for name, is_set in {"checkpoint": checkpoint is not None or checkpoint_every != 0,
                         "compiled": compiled, "mesh": mesh is not None,
                         "timings": timings is not None}.items():
        if is_set:
            raise NotImplementedError(f"{name}: {_DEFERRED}")
    if use_pallas not in (False, True, "frame"):
        raise ValueError(f"use_pallas={use_pallas!r}: expected False, True or 'frame'")
    if use_pallas and (cfg.sps != 2 or cfg.m_est % 2 == 0):
        raise ValueError("use_pallas requires sps=2 and odd M_est")

    device = resolve_device(device)
    R = 1 if runs is None else runs
    const, sims, amps, P, var = _setup(cfg, device)
    draws = draws or _default_draws(sims, seed, device)
    params = params_init or {"w": siso_fir_init(cfg.m_est), "h": dirac_taps_siso(cfg.m_est)}
    params = {"w": _per_run(params["w"], R, 3, device), "h": _per_run(params["h"], R, 2, device)}

    if use_pallas == "frame":
        rb = runs_batch or R
        if R % rb != 0:
            raise ValueError(f"runs_batch={rb} must divide runs={R}")
        rx_epochs = _frame_train_data(sims["train"], draws, R, cfg.num_epochs)
        params, w_ev = _frame_train(cfg, params, rx_epochs, amps, P, var, const.amp_mean, rb)
        packed = _frame_evals(cfg, w_ev, draws, sims["valid"], const, amps, P, var)
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
        params, packed = _run_epochs(cfg, step_fn, params, draws, sims, const, amps, P, var, R,
                                     progress)

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
    loop-mode eval.

    Returns {"ser" (..., n_evals), "mi" (..., n_evals), "params" {"net",
    "h"[, "bn"]}} with a leading runs axis iff ``runs``.
    """
    for name, is_set in {"checkpoint": checkpoint is not None or checkpoint_every != 0,
                         "compiled": compiled, "mesh": mesh is not None,
                         "timings": timings is not None}.items():
        if is_set:
            raise NotImplementedError(f"{name}: {_DEFERRED_NN}")
    if use_pallas is True:
        raise ValueError("VAE-NN has no per-step kernel mode; use use_pallas='frame'")
    if use_pallas not in (False, "frame"):
        raise ValueError(f"use_pallas={use_pallas!r}: expected False or 'frame'")
    if use_pallas == "frame" and (cfg.sps != 2 or cfg.m_est % 2 == 0 or cfg.kernel_2 != 3):
        raise ValueError('use_pallas="frame" requires sps=2, odd m_est and kernel_2=3')

    device = resolve_device(device)
    R = 1 if runs is None else runs
    const, sims, amps, P, _ = _setup(cfg, device, fixed_noise=True)
    draws = draws or _default_draws(sims, seed, device)
    if params_init is None:
        gen = torch.Generator()
        gen.manual_seed(seed ^ 0x5EED)
        net, bn_state = vae_nn_init(gen, cfg.kernel_1, cfg.kernel_2, const.num_lev, cfg.batchnorm)
        params_init = {"net": net, "h": dirac_taps_siso(cfg.m_est)}
        if cfg.batchnorm:
            params_init["bn"] = bn_state

    net0 = {k: _per_run(v, R, 3 if k[0] == "w" else 1, device) for k, v in params_init["net"].items()}
    w1f, w2f = (t.contiguous() for t in flatten_nn_params(net0))
    h = _per_run(params_init["h"], R, 2, device)
    ch, k1 = w1f.shape[-2], cfg.kernel_1
    bn = None
    if cfg.batchnorm:
        st = params_init["bn"]
        momentum = float(st["momentum"])
        bn = (torch.stack([net0["bn_scale"], net0["bn_bias"]], dim=-1),
              torch.stack([_per_run(st["mean"], R, 1, device), _per_run(st["var"], R, 1, device)],
                          dim=-1))
    else:
        momentum = 0.1
    opt = nn_frame_opt_init(w1f, w2f, h, None if bn is None else bn[0])
    n_batches = cfg.n_train // cfg.batch_len
    n_evals = cfg.num_epochs // cfg.epe
    kw = dict(bl_sym=cfg.batch_len, n_batches=n_batches, k1=k1)

    if use_pallas == "frame":
        rx_epochs = _frame_train_data(sims["train"], draws, R, cfg.num_epochs)
        w1f, w2f, h, bnp, rs, _, _, *evs = vae_nn_experiment_train(
            w1f, w2f, h, opt, rx_epochs, amps, cfg.lr, bn, momentum, epe=cfg.epe, **kw)
        w1_ev, w2_ev, _, bnp_ev, rs_ev = evs
        packed = _batched_evals(n_evals, R, draws, lambda sl, vd: _nn_evaluate(
            cfg, nn_net(w1_ev[sl], w2_ev[sl], bnp_ev[sl], k1, cfg.batchnorm), rs_ev[sl], vd,
            sims["valid"], const, amps, P))
    else:
        bnp, rs = bn if bn is not None else (w1f.new_zeros((R, ch, 2)),) * 2
        packed = np.zeros((R, n_evals, len(_EVAL_NAMES)), np.float32)
        for epoch in range(cfg.num_epochs):
            rx, _, _ = sims["train"].physics(*draws("train", epoch, R))
            w1f, w2f, h, bnp, rs, opt, losses, *_ = vae_nn_experiment_train_plain(
                w1f, w2f, h, opt, rx[:, None], amps, cfg.lr, (bnp, rs) if bn is not None else None,
                momentum, epe=1, step0=epoch * n_batches, **kw)
            if epoch % cfg.epe == 0 and epoch // cfg.epe < n_evals:
                i = epoch // cfg.epe
                packed[:, i] = _nn_evaluate(cfg, nn_net(w1f, w2f, bnp, k1, cfg.batchnorm), rs,
                                            draws("valid", i, R), sims["valid"], const, amps,
                                            P).cpu().numpy()  # one device-to-host copy per eval
                if progress:
                    progress(epoch, {"loss": losses[-1].cpu().numpy(),
                                     **{n: packed[:, i, j] for j, n in enumerate(_EVAL_NAMES)}})

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
    "loss".

    Returns {"ser" (..., n_evals), "mi" (..., n_evals), "taps" (..., 2, M)}
    with a leading runs axis iff ``runs``.
    """
    for name, is_set in {"checkpoint": checkpoint is not None or checkpoint_every != 0,
                         "compiled": compiled, "mesh": mesh is not None,
                         "timings": timings is not None}.items():
        if is_set:
            raise NotImplementedError(f"{name}: {_DEFERRED_CMA}")
    device = resolve_device(device)
    R = 1 if runs is None else runs
    const, sims, amps, P, var = _setup(cfg, device)
    draws = draws or _default_draws(sims, seed, device)
    var_q = torch.full((1,), var, dtype=torch.float32, device=device)
    n_evals = cfg.num_epochs // cfg.epe

    rx_epochs = _frame_train_data(sims["train"], draws, R, cfg.num_epochs)
    h0 = _per_run(dirac_taps_siso(cfg.m_est), R, 2, device)
    taps, h_ev, loss = cma_siso_experiment(rx_epochs, h0, cfg.R, cfg.lr, cfg.sps, cfg.epe)
    packed = _batched_evals(n_evals, R, draws, lambda sl, vd: _cma_evaluate(
        cfg, h_ev[sl], vd, sims["valid"], amps, P, var_q, const.nu_sc))
    loss = loss.cpu().numpy()
    if runs is None:
        packed, taps, loss = packed[0], taps[0], loss[0]
    if progress:
        for i in range(n_evals):
            progress(i * cfg.epe, {"loss": loss[..., i * cfg.epe],
                                   **{n: packed[..., i, j] for j, n in enumerate(_EVAL_NAMES)}})
    return {"ser": packed[..., 0], "mi": packed[..., 1], "taps": taps}
