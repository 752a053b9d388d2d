#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives the port's two paths through their hand-written CUDA kernels, after
building them from ``csrc/`` and holding each kernel against its plain
PyTorch version at its path's shapes: the flagship DP VAE online-training
experiment (``vae_equalizer_tpu_torch.train.train_vae_dp``, DpConfig()
defaults: 64-QAM, M = 25, bl = 100, 170 frames x 10,000 symbols, 8 runs)
the CMA / CMAbatch / CMAflex baselines on the same channel (``run_cma_dp``,
5 runs) and the AWGN VAE-LE experiment (``train_vae_le_awgn``, 20 runs).
One line per phase:

  1. device    card name and power limit (nvidia-smi)
  2. build     nvcc build of kernels A-D, F, G (one nvcc per source, in parallel),
               seconds, ptxas resource use
  3. kernel A  vs plain (one minibatch), errors and CUDA-event times
  4. kernel B  vs plain: (a) a 3-minibatch frame, R = 8, across the lr
               halving; (b) a full 100-step frame; times
  5. main path the full VAE experiment; launch count, soft SER band, MI, speed
  6. breakdown per-frame channel / kernel B / eval times
  7. kernel C  vs plain: a whole 10,000-symbol CMA frame, R = 5; times
  8. kernel D  vs plain: a whole CMAbatch and a whole CMAflex frame, R = 5
  9. CMA path  the three 170-frame CMA experiments, R = 5: launch counts,
               constellation SER band, speed; per-frame channel / kernel /
               eval times
 10. kernel F  vs plain: one 350-symbol AWGN minibatch, 64-QAM, R = 20; times
 11. kernel G  vs plain: (a) 2 epochs from a near-Dirac start; (b) 10 epochs
               from the state after 50 trained epochs; the whole 1,500-step
               experiment timed against the plain engine
 12. AWGN path the full AWGN VAE-LE experiment (``train_vae_le_awgn``,
               AwgnVaeLeConfig(): 64-QAM, h1, 24 dB, 500 epochs, 250 evals),
               R = 20, with use_pallas="frame" (kernel G) and True (kernel F):
               launch counts, last-25-evals SER band, final MI, speed;
               channel / kernel / eval split

then the kernels' JSON line, the card line, and as the last line
``{"ok": true, "device": {...}}``. Any failed phase raises (non-zero exit,
no result line); without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

DEVICE = "cuda"
SER_BAND = (0.029, 0.034)  # bench.py:196, last-20-frame mean soft SER of the flagship
MI_MIN = 5.0  # bits, every run's final MI (tests/test_train.py:167-168)
WARM_FRAMES = 20  # frames of training before the 100-step comparison
CMA_RUNS = 5  # the reference's DP CMA repeats (Eval_run_DP.py: iter=5)
# per CMA variant: (use_pallas, lr, last-20-frame constellation SER band).
# lr and band from the JAX package's run_cma_dp on the CPU at this config
# (64-QAM, M 25, SNR 23 dB, 170 x 10,000, runs 2, keys 0 and 1): the spread
# of its 4 per-run values widened by 0.003 on each side (PERF.md)
CMA_VARIANTS = {
    "CMA": (True, 1e-4, (0.0634, 0.0711)),
    "CMAbatch": ("frame", 1e-4, (0.0650, 0.0724)),
    "CMAflex": ("frame", 1e-5, (0.0647, 0.0724)),
}
AWGN_RUNS = 20  # Eval_run_shaping_vaele's default repeats (drivers/eval_run_shaping_vaele.py:36)
# Per run, the mean SER of the last 25 evals. The JAX package at
# AwgnVaeLeConfig() (runs 2 and 20, keys 0 and 1; 44 runs, PERF.md §6)
# spans 0.00821-0.01063 in converged runs; the band is that spread widened 2x
# about its middle and holds the reference's 0.009266. The VAE-LE from the
# Dirac start sometimes settles in a wrong equalizer (last-25 SER ~0.87, MI
# ~-34 bits; the JAX package too, 2 of 148 runs): a run above
# AWGN_STUCK_SER counts as stuck, and at most AWGN_MAX_STUCK of the 20 may be.
# The median over runs and the mean over converged runs must lie in the band.
AWGN_SER_BAND = (0.00700, 0.01184)
AWGN_STUCK_SER = 0.05
AWGN_MAX_STUCK = 3
AWGN_MI_MIN = 5.90  # bits, each converged run's final MI (JAX: 5.937-5.974)
AWGN_WARM_EPOCHS = 50  # epochs of training before the 10-epoch comparison


def _line(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def _check(name, got, want, rtol, atol, errs):
    """Elementwise |got - want| <= atol + rtol |want|; records max abs/rel errors."""
    g, w = got.double(), want.double()
    diff = (g - w).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / w.abs().clamp_min(1e-30)).max())
    errs[name] = (max_abs, max_rel)
    bad = diff > atol + rtol * w.abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements beyond rtol={rtol} atol={atol}; "
                             f"max abs {max_abs:.3e}, max rel {max_rel:.3e}")


def _fmt(errs):
    return ",".join(f"{k}:{a:.2e}/{r:.2e}" for k, (a, r) in errs.items())


def _time_ms(fn, reps: int = 5, warmup: bool = True) -> float:
    """Median CUDA-event time of fn() over reps runs, after one warm-up."""
    import torch

    if warmup:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _dec_ties_only(dec, dec_ref, out, amps, var, nu_sc, tol=1e-4):
    """Decision mismatches must sit where the two smallest demapper metrics
    are within `tol` (relative) — a tie to float32 rounding."""
    import torch

    mism = dec != dec_ref
    if not bool(mism.any()):
        return 0, 0
    met = (out[..., None, :] - amps[:, None]) ** 2 / (2 * var[:, None, None, None]) \
        + nu_sc * (amps * amps)[:, None]
    two = met.topk(2, dim=-2, largest=False).values
    gap = (two[..., 1, :] - two[..., 0, :]) / two[..., 0, :].abs().clamp_min(1.0)
    non_tie = mism & (gap > tol)
    if bool(non_tie.any()):
        raise AssertionError(f"dec: {int(non_tie.sum())} mismatches away from ties")
    return int(mism.sum()), int(mism.numel())


def _awgn_phases(card: str) -> list:
    """Phases 10-12: kernels F and G against their plain versions, then the
    AWGN VAE-LE path in both kernel modes, counted. Returns the kernels' JSON
    entries."""
    import numpy as np
    import torch

    from vae_equalizer_tpu_torch.models import dirac_taps_siso, siso_fir_init, vae_le_siso_forward
    from vae_equalizer_tpu_torch.ops.cma_frame_kernel import cma_chunked_frame
    from vae_equalizer_tpu_torch.ops.cma_kernel import cma_dp_kernel
    from vae_equalizer_tpu_torch.ops.elbo_kernel import vae_dp_loss_and_grad
    from vae_equalizer_tpu_torch.ops.elbo_siso_kernel import (
        vae_siso_loss_and_grad,
        vae_siso_loss_and_grad_plain,
    )
    from vae_equalizer_tpu_torch.ops.frame_kernel import vae_dp_frame_train
    from vae_equalizer_tpu_torch.ops.siso_frame_kernel import (
        amsgrad,
        siso_frame_opt_init,
        vae_siso_experiment_train,
        vae_siso_experiment_train_plain,
    )
    from vae_equalizer_tpu_torch.train import awgn as train_awgn
    from vae_equalizer_tpu_torch.utils import AwgnVaeLeConfig

    dev = torch.device(DEVICE)
    cfg = AwgnVaeLeConfig()
    const, sims, amps, P, var = train_awgn._setup(cfg, dev)
    R, M, bl = AWGN_RUNS, cfg.m_est, cfg.batch_len
    nb = cfg.n_train // cfg.batch_len
    amp_mean = const.amp_mean
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    rng = torch.Generator(device=dev)
    rng.manual_seed(77)
    draws = lambda kind, index, runs: sims[kind].draws(gen, runs)
    rx_epochs = lambda n_ep: train_awgn._frame_train_data(sims["train"], draws, R, n_ep)
    w0 = siso_fir_init(M, dev) + 0.01 * torch.randn((R, 1, 2, M), generator=rng, device=dev)
    h0 = dirac_taps_siso(M, dev) + 0.01 * torch.randn((R, 2, M), generator=rng, device=dev)
    opt0 = siso_frame_opt_init({"w": w0, "h": h0})
    g_kw = dict(bl_sym=bl, n_batches=nb, epe=cfg.epe)

    # ---- 10. kernel F vs plain: one minibatch of a channel frame, R = 20
    # (float32 sums in another order through the softmin's 1/var = 251 gain:
    # rtol 1e-4 with a floor of 1e-4 of each tensor's scale; loss rtol 1e-5)
    x = rx_epochs(1)[:, 0, :, : 2 * bl].contiguous()
    f_args = (w0, h0, x, amps, amp_mean, var, P)
    got = vae_siso_loss_and_grad(*f_args)
    torch.cuda.synchronize()
    want = vae_siso_loss_and_grad_plain(*f_args)
    errs_f: dict = {}
    _check("loss", got[0], want[0], 1e-5, 0.0, errs_f)
    for name, g_, w_ in zip(("gw", "gh", "q", "out"), got[1:], want[1:]):
        _check(name, g_, w_, 1e-4, 1e-4 * float(w_.abs().max()), errs_f)
    ms_f = _time_ms(lambda: vae_siso_loss_and_grad(*f_args))
    ms_f_plain = _time_ms(lambda: vae_siso_loss_and_grad_plain(*f_args))
    _line("10 kernel F", ok=True, R=R, bl=bl, errs_abs_rel=_fmt(errs_f), ms=f"{ms_f:.4f}",
          plain_ms=f"{ms_f_plain:.4f}")

    # ---- 11a. kernel G vs plain: 2 epochs (6 steps) from the near-Dirac start
    g_args = (w0, h0, opt0, rx_epochs(2), amps, amp_mean, var, P, cfg.lr)
    got = vae_siso_experiment_train(*g_args, **g_kw)
    torch.cuda.synchronize()
    want = vae_siso_experiment_train_plain(*g_args, **g_kw)
    errs_ga: dict = {}
    _check("losses", got[3], want[3], 1e-4, 0.0, errs_ga)
    # AMSGrad's first steps move each tap by ~lr whatever the gradient's size
    # and amplify rounding (PERF.md §6): taps at rtol 1e-2, 1e-4
    for i, name in ((0, "w"), (1, "h"), (4, "w_ev"), (5, "h_ev")):
        _check(name, got[i], want[i], 1e-2, 1e-4, errs_ga)
    g_err = max(errs_ga["w"][0], errs_ga["h"][0])
    _line("11a kernel G 2 epochs", ok=True, R=R, errs_abs_rel=_fmt(errs_ga))

    # ---- 11b. 10 epochs from the state after AWGN_WARM_EPOCHS trained epochs
    warm = vae_siso_experiment_train(*(w0, h0, opt0, rx_epochs(AWGN_WARM_EPOCHS)), amps, amp_mean, var,
                                     P, cfg.lr, **g_kw)
    b_args = (*warm[:3], rx_epochs(10), amps, amp_mean, var, P, cfg.lr)
    step0 = AWGN_WARM_EPOCHS * nb
    got = vae_siso_experiment_train(*b_args, **g_kw, step0=step0)
    torch.cuda.synchronize()
    want = vae_siso_experiment_train_plain(*b_args, **g_kw, step0=step0)
    errs_gb: dict = {}
    _check("losses", got[3], want[3], 1e-3, 0.0, errs_gb)
    rx_v, _, _ = sims["valid"](gen, R)
    decide = lambda w: vae_le_siso_forward(w, rx_v, amps, amp_mean, var, 2)[0].unflatten(-2, (2, -1)).argmax(-2)
    agree = min(float((decide(got[4][i]) == decide(want[4][i])).float().mean())
                for i in range(got[4].shape[0]))
    if agree < 0.999:
        raise AssertionError(f"10-epoch G: eval-slot decision agreement {agree:.5f} < 0.999")

    # the whole experiment: 500 epochs x 3 steps, R = 20
    full_args = (w0, h0, opt0, rx_epochs(cfg.num_epochs), amps, amp_mean, var, P, cfg.lr)
    ms_g = _time_ms(lambda: vae_siso_experiment_train(*full_args, **g_kw), reps=3)
    ms_g_plain = _time_ms(lambda: vae_siso_experiment_train_plain(*full_args, **g_kw), reps=1,
                          warmup=False)
    _line("11b kernel G 10 epochs", ok=True, R=R, step0=step0, errs_abs_rel=_fmt(errs_gb),
          slot_dec_agree=f"{agree:.6f}", experiment_ms=f"{ms_g:.3f}",
          experiment_plain_ms=f"{ms_g_plain:.3f}", steps=cfg.num_epochs * nb)

    # ---- 12. the AWGN path in both kernel modes, counted
    counters = (vae_dp_frame_train, vae_dp_loss_and_grad, cma_dp_kernel, cma_chunked_frame,
                vae_siso_loss_and_grad, vae_siso_experiment_train)
    steps = cfg.num_epochs * nb
    expect = {"frame": (vae_siso_experiment_train, 1), True: (vae_siso_loss_and_grad, steps)}
    launches = {}
    n_evals = cfg.num_epochs // cfg.epe
    for mode, (kern, n_expect) in expect.items():
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train_awgn.train_vae_le_awgn(cfg, seed=0, device=DEVICE, runs=R, use_pallas=mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {c.__name__: c.launches for c in counters}
        if counts[kern.__name__] != n_expect or sum(counts.values()) != n_expect:
            raise AssertionError(f"AWGN use_pallas={mode!r}: launches {counts}, expected {n_expect} "
                                 f"of {kern.__name__}")
        launches[kern.__name__] = n_expect
        for k in ("ser", "mi"):
            if res[k].shape != (R, n_evals) or not np.all(np.isfinite(res[k])):
                raise AssertionError(f"AWGN {k}: shape {res[k].shape} or non-finite values")
        ser25 = res["ser"][:, -25:].mean(-1)  # (R,) last-25-evals mean SER per run
        ok = ser25 <= AWGN_STUCK_SER
        stats = {"median": float(np.median(ser25)), "converged_mean": float(ser25[ok].mean()),
                 "stuck": int((~ok).sum())}
        mi_last = res["mi"][ok, -1]
        lo, hi = AWGN_SER_BAND
        if (stats["stuck"] > AWGN_MAX_STUCK or not lo <= stats["median"] <= hi
                or not lo <= stats["converged_mean"] <= hi or not np.all(mi_last > AWGN_MI_MIN)):
            raise AssertionError(f"AWGN use_pallas={mode!r}: last-25-evals SER {stats} (band "
                                 f"{AWGN_SER_BAND}, at most {AWGN_MAX_STUCK} stuck), converged "
                                 f"runs' final MI min {mi_last.min():.4f} (floor {AWGN_MI_MIN})")
        split = _awgn_split(mode, cfg, train_awgn, sims, draws, amps, P, var, const, w0, h0,
                            vae_siso_loss_and_grad, amsgrad, rx_epochs)
        _line(f"12 AWGN path {mode!r}", ok=True, runs=R, epochs=cfg.num_epochs, evals=n_evals,
              launches=counts[kern.__name__], ser_last25_median=f"{stats['median']:.6f}",
              ser_last25_converged_mean=f"{stats['converged_mean']:.6f}",
              ser_last25_mean_all=f"{ser25.mean():.6f}", stuck=stats["stuck"], band=AWGN_SER_BAND,
              ser_last25_converged_min_max=f"{ser25[ok].min():.6f}/{ser25[ok].max():.6f}",
              mi_final_min=f"{mi_last.min():.4f}", mi_final_mean=f"{mi_last.mean():.4f}",
              wall_s=f"{wall:.3f}", train_sym_per_s=f"{R * cfg.num_epochs * cfg.n_train / wall:.0f}",
              **split, card=repr(card))
        for c in counters:
            c.launches = 0

    src = "vae_equalizer_tpu_torch/csrc/siso_kernels.cu"
    return [
        {"name": "vae_siso_loss_and_grad", "route": "cuda", "source": src,
         "replaces": "vae_equalizer_tpu/ops/elbo_siso_kernel.py:283",
         "launches": launches["vae_siso_loss_and_grad"],
         "max_abs_err": max(errs_f["gw"][0], errs_f["gh"][0]), "ms": ms_f, "plain_ms": ms_f_plain},
        {"name": "vae_siso_experiment_train", "route": "cuda", "source": src,
         "replaces": "vae_equalizer_tpu/ops/siso_frame_kernel.py:842",
         "launches": launches["vae_siso_experiment_train"], "max_abs_err": g_err, "ms": ms_g,
         "plain_ms": ms_g_plain},
    ]


def _awgn_split(mode, cfg, train_awgn, sims, draws, amps, P, var, const, w0, h0, step_kernel,
                amsgrad, rx_epochs) -> dict:
    """Channel / kernel / eval time of one AWGN experiment (CUDA events), at
    the main path's shapes. Frame mode: its three stages timed once each (the
    eval stage draws its validation frames too). Loop modes: the units — a
    training frame, a validation frame, one minibatch step (kernel F +
    AMSGrad), one eval (forward, sync, SER, MI, one copy to the host) —
    as medians, times their counts."""
    import torch

    from vae_equalizer_tpu_torch.models import vae_le_siso_forward
    from vae_equalizer_tpu_torch.ops.siso_frame_kernel import siso_frame_opt_init

    R = w0.shape[0]
    n_evals = cfg.num_epochs // cfg.epe
    st = {}
    if mode == "frame":
        def channel():
            st["rx"] = rx_epochs(cfg.num_epochs)

        def kernel():
            st["w_ev"] = train_awgn._frame_train(cfg, {"w": w0, "h": h0}, st["rx"], amps, P, var,
                                                 const.amp_mean, R)[1]

        def evaluate():
            train_awgn._frame_evals(cfg, st["w_ev"], draws, sims["valid"], const, amps, P, var)

        ms = [_time_ms(f, reps=1, warmup=False) for f in (channel, kernel, evaluate)]
        return dict(channel_ms=f"{ms[0]:.3f}", kernel_ms=f"{ms[1]:.3f}", eval_ms=f"{ms[2]:.3f}")

    opt = siso_frame_opt_init({"w": w0, "h": h0})
    x = rx_epochs(1)[:, 0, :, : 2 * cfg.batch_len].contiguous()

    def channel_epoch():
        sims["train"].physics(*draws("train", 0, R))

    def channel_eval():
        st["v"] = sims["valid"].physics(*draws("valid", 0, R))

    def step():
        _, gw, gh = step_kernel(w0, h0, x, amps, const.amp_mean, var, P)[:3]
        amsgrad(w0, opt["mw"], opt["vw"], opt["xw"], gw, cfg.lr, 0)
        amsgrad(h0, opt["mh"], opt["vh"], opt["xh"], gh, cfg.lr, 0)

    def evaluate():
        q, _ = vae_le_siso_forward(w0, st["v"][0], amps, const.amp_mean, var, cfg.sps)
        train_awgn._siso_eval_pack(q, st["v"][1], cfg.n_valid, const, amps, P).cpu()

    t_ch, t_chv, t_step, t_ev = (_time_ms(f) for f in (channel_epoch, channel_eval, step, evaluate))
    nb = cfg.n_train // cfg.batch_len
    return dict(channel_ms=f"{cfg.num_epochs * t_ch + n_evals * t_chv:.3f}",
                kernel_ms=f"{cfg.num_epochs * nb * t_step:.3f}", eval_ms=f"{n_evals * t_ev:.3f}",
                step_unit_ms=f"{t_step:.4f}", eval_unit_ms=f"{t_ev:.3f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import numpy as np

    from vae_equalizer_tpu_torch.models import butterfly_init, dirac_taps_dp
    from vae_equalizer_tpu_torch.ops import _build
    from vae_equalizer_tpu_torch.ops.cma_frame_kernel import cma_chunked_frame, cma_chunked_frame_plain
    from vae_equalizer_tpu_torch.ops.cma_kernel import cma_dp_kernel, cma_dp_plain
    from vae_equalizer_tpu_torch.ops.elbo_kernel import vae_dp_loss_and_grad, vae_dp_loss_and_grad_plain
    from vae_equalizer_tpu_torch.ops.frame_kernel import (
        frame_opt_init,
        vae_dp_frame_train,
        vae_dp_frame_train_plain,
    )
    from vae_equalizer_tpu_torch.train import dp as train_dp
    from vae_equalizer_tpu_torch.utils import DpConfig

    # the plain versions are the reference: full float32 everywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)

    # ---- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    _line("1 device", card=repr(card), torch=torch.__version__, cuda=torch.version.cuda,
          count=torch.cuda.device_count())

    # ---- 2. build
    _, build_s, log = _build.build()
    _build.load()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "Compiling entry" in ln]
    _line("2 build", seconds=f"{build_s:.1f}", ptxas=repr(" | ".join(ptxas)))

    # flagship inputs: one frame of the DP channel, w/h near Dirac
    cfg = DpConfig()
    m_max = cfg.n_frame_max // cfg.batch_len
    n_sym_frame = m_max * cfg.batch_len
    const, var, sim, amps, P = train_dp._setup(cfg, n_sym_frame, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    R = 8
    rx, _, _ = sim(gen, float(np.float32(cfg.theta)), R)
    rng = torch.Generator(device=dev)
    rng.manual_seed(99)
    M = cfg.m_est
    w0 = butterfly_init(M, dev) + 0.01 * torch.randn((R, 2, 4, M), generator=rng, device=dev)
    h0 = dirac_taps_dp(M, dev) + 0.01 * torch.randn((R, 2, 2, 2, M), generator=rng, device=dev)
    nu_sc, lr = const.nu_sc, cfg.lr
    bl = cfg.batch_len

    # ---- 3. kernel A vs plain (rtol 1e-4: float32 sums in another order)
    x1 = rx[0, ..., : 2 * bl].contiguous()
    a_args = (w0[0].contiguous(), h0[0].contiguous(), x1, amps, var, nu_sc, P)
    got = vae_dp_loss_and_grad(*a_args)
    torch.cuda.synchronize()
    want = vae_dp_loss_and_grad_plain(*a_args)
    errs_a: dict = {}
    for name, g, w in zip(("loss", "var_est", "gw", "gh", "q", "out"), got, want):
        _check(name, g, w, 1e-4, 1e-4 * float(w.abs().max()), errs_a)
    ms_a = _time_ms(lambda: vae_dp_loss_and_grad(*a_args))
    ms_a_plain = _time_ms(lambda: vae_dp_loss_and_grad_plain(*a_args))
    _line("3 kernel A", ok=True, errs_abs_rel=_fmt(errs_a), ms=f"{ms_a:.4f}", plain_ms=f"{ms_a_plain:.4f}")

    # ---- 4a. kernel B vs plain: 3 minibatches, R = 8, w lr halves at the 2nd
    opt0 = frame_opt_init({"w": w0, "h": h0})
    rx3 = rx[..., : 3 * 2 * bl].contiguous()
    b_args = (w0, h0, opt0, rx3, amps, var, nu_sc, P, lr, 40, 41.0)
    got = vae_dp_frame_train(*b_args, bl_sym=bl)
    torch.cuda.synchronize()
    want = vae_dp_frame_train_plain(*b_args, bl_sym=bl)
    names = ("w", "h", "opt", "losses", "var_est", "out", "dec", "eq", "mm", "s1")
    g, w = dict(zip(names, got)), dict(zip(names, want))
    errs_b: dict = {}
    for k in ("w", "h", "losses", "var_est"):
        _check(k, g[k], w[k], 1e-4, 3e-7, errs_b)
    # the moments are raw gradients of scale ~1e1-1e2: an absolute 3e-7 floor
    # is below one float32 ulp there, so their floor is 1e-5 of their scale
    for k in ("mw", "vw", "mh", "vh"):
        _check(k, g["opt"][k], w["opt"][k], 1e-4, 1e-5 * float(w["opt"][k].abs().max()), errs_b)
    for k in ("out", "eq", "s1"):
        _check(k, g[k], w[k], 1e-4, 1e-6, errs_b)
    # mm = min_l (out - a_l)^2 / (2 var): near-zero minima carry the output's
    # absolute error times the 1/(2 var) gain
    _check("mm", g["mm"], w["mm"], 1e-4, 1e-4, errs_b)
    dec_mis = _dec_ties_only(g["dec"], w["dec"], w["out"], amps, var, nu_sc)
    b_err = max(errs_b["w"][0], errs_b["h"][0])
    _line("4a kernel B 3 steps", ok=True, R=R, errs_abs_rel=_fmt(errs_b), dec_tie_mismatch=dec_mis)

    # ---- 4b. one full 100-step frame at flagship lr, from the state after 20
    # frames of training (from a cold start, Adam's first steps amplify
    # rounding chaotically: zero moments turn sign flips of ~0 gradients into
    # +-lr updates); times
    warm = WARM_FRAMES
    thetas = train_dp._frame_inputs(dataclasses.replace(cfg, num_frames=warm + 1), dev)
    wk = butterfly_init(M, dev).expand(R, 2, 4, M).contiguous()
    hk = dirac_taps_dp(M, dev).expand(R, 2, 2, 2, M).contiguous()
    optk, thresh = frame_opt_init({"w": wk, "h": hk}), float(cfg.n_lrhalf * m_max)
    for f in range(warm):
        rx_f, _, _ = sim(gen, thetas[f], R)
        wk, hk, optk = vae_dp_frame_train(wk, hk, optk, rx_f, amps, var, nu_sc, P, lr, f * m_max,
                                          thresh, bl_sym=bl)[:3]
    rx_f, _, _ = sim(gen, thetas[warm], R)
    f_args = (wk, hk, optk, rx_f, amps, var, nu_sc, P, lr, warm * m_max, thresh)
    got = vae_dp_frame_train(*f_args, bl_sym=bl)
    torch.cuda.synchronize()
    want = vae_dp_frame_train_plain(*f_args, bl_sym=bl)
    errs_f: dict = {}
    # Adam amplifies per-step rounding over 100 dependent steps
    # (tests/test_frame_kernel.py:169-174): losses at rtol 1e-3
    _check("losses", got[3], want[3], 1e-3, 0.0, errs_f)
    agree = float((got[6] == want[6]).float().mean())
    if agree < 0.999:
        raise AssertionError(f"100-step frame: dec agreement {agree:.5f} < 0.999")
    ms_b = _time_ms(lambda: vae_dp_frame_train(*f_args, bl_sym=bl))
    ms_b_plain = _time_ms(lambda: vae_dp_frame_train_plain(*f_args, bl_sym=bl))
    _line("4b kernel B 100 steps", ok=True, R=R, errs_abs_rel=_fmt(errs_f), dec_agree=f"{agree:.6f}",
          ms=f"{ms_b:.3f}", plain_ms=f"{ms_b_plain:.3f}")

    # ---- 5. the main path, counted
    vae_dp_frame_train.launches = 0
    vae_dp_loss_and_grad.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train_dp.train_vae_dp(cfg, seed=0, device=DEVICE, use_pallas="frame", runs=R)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_b = vae_dp_frame_train.launches
    if launches_b != cfg.num_frames:
        raise AssertionError(f"kernel B launched {launches_b} times, expected {cfg.num_frames}")
    for k in ("ser", "mi", "var_est"):
        if not np.all(np.isfinite(res[k])):
            raise AssertionError(f"non-finite {k}")
    if res["ser"].shape != (R, 4, cfg.num_frames) or res["mi"].shape != (R, 2, cfg.num_frames):
        raise AssertionError(f"result shapes {res['ser'].shape} {res['mi'].shape}")
    soft = float(res["ser"][:, 2:, -20:].mean())
    if not SER_BAND[0] <= soft <= SER_BAND[1]:
        raise AssertionError(f"last-20-frame soft SER {soft:.5f} outside {SER_BAND}")
    mi_last = res["mi"][:, :, -1]
    if not np.all(mi_last > MI_MIN):
        raise AssertionError(f"final MI {mi_last.min():.3f} <= {MI_MIN} bits")
    sym_s = R * cfg.num_frames * n_sym_frame / wall
    _line("5 main path", ok=True, runs=R, frames=cfg.num_frames, kernel_b_launches=launches_b,
          soft_ser_last20=f"{soft:.5f}", const_ser_last20=f"{float(res['ser'][:, :2, -20:].mean()):.5f}",
          mi_final_min=f"{mi_last.min():.4f}", wall_s=f"{wall:.3f}", sym_per_s=f"{sym_s:.0f}",
          card=repr(card))

    # ---- 6. per-frame breakdown at the main path's shapes (CUDA events)
    opt = frame_opt_init({"w": w0, "h": h0})
    wfn = lambda s0, ms, t=None: train_dp.batch_cut_weight(m_max, bl, s0, ms, cfg.n_cut, t=t)
    state = {}

    def channel():
        state["ch"] = sim(gen, thetas[0], R)

    def kernel():
        state["k"] = vae_dp_frame_train(w0, h0, opt, state["ch"][0], amps, var, nu_sc, P, lr, 0,
                                        1e9, bl_sym=bl)

    def evaluate():
        k = state["k"]
        train_dp._finish_vae_frame(k[3], k[5], k[4], state["ch"][1], const, amps, P, var, wfn,
                                   state["ch"][2], k[6], k[7], k[8], k[9])

    ms_ch, ms_k, ms_ev = _time_ms(channel), _time_ms(kernel), _time_ms(evaluate)
    _line("6 breakdown", runs=R, channel_ms=f"{ms_ch:.3f}", kernel_b_ms=f"{ms_k:.3f}",
          eval_ms=f"{ms_ev:.3f}", frame_wall_ms=f"{1e3 * wall / cfg.num_frames:.3f}")

    # ---- 7. kernel C vs plain: one whole CMA frame (10,000 symbols), R = 5
    # (rtol 1e-4 with an absolute floor of 1e-6 of each tensor's scale:
    # float32 sums in another order; CMA has no Adam to amplify them)
    Rc = CMA_RUNS
    rx_c = sim(gen, thetas[0], Rc)[0]
    h_c = dirac_taps_dp(M, dev) + 0.01 * torch.randn((Rc, 2, 2, 2, M), generator=rng, device=dev)
    lr_c = CMA_VARIANTS["CMA"][1]
    got = cma_dp_kernel(rx_c, cfg.R, h_c, lr_c, cfg.sps)
    torch.cuda.synchronize()
    want = cma_dp_plain(rx_c, cfg.R, h_c, lr_c, cfg.sps)
    errs_c: dict = {}
    for name, g_, w_ in zip(("out", "h", "e"), got, want):
        _check(name, g_, w_, 1e-4, 1e-6 * float(w_.abs().max()), errs_c)
    ms_c = _time_ms(lambda: cma_dp_kernel(rx_c, cfg.R, h_c, lr_c, cfg.sps))
    # the plain per-symbol loop is ~10^5 small launches: one timed frame
    ms_c_plain = _time_ms(lambda: cma_dp_plain(rx_c, cfg.R, h_c, lr_c, cfg.sps), reps=1, warmup=False)
    _line("7 kernel C", ok=True, R=Rc, errs_abs_rel=_fmt(errs_c), ms=f"{ms_c:.4f}",
          plain_ms=f"{ms_c_plain:.3f}")

    # ---- 8. kernel D vs plain: one whole CMAbatch and CMAflex frame, R = 5
    d_res = {}
    for v, S in (("CMAbatch", cfg.batch_len), ("CMAflex", cfg.flex_step)):
        lr_v = CMA_VARIANTS[v][1]
        d_args = (rx_c, cfg.R, h_c, lr_v, cfg.batch_len, S, cfg.sps)
        got = cma_chunked_frame(*d_args)
        torch.cuda.synchronize()
        want = cma_chunked_frame_plain(*d_args)
        errs_d: dict = {}
        for name, g_, w_ in zip(("out", "h", "e"), got, want):
            _check(name, g_, w_, 1e-4, 1e-6 * float(w_.abs().max()), errs_d)
        ms_d = _time_ms(lambda: cma_chunked_frame(*d_args))
        ms_d_plain = _time_ms(lambda: cma_chunked_frame_plain(*d_args), reps=1, warmup=False)
        d_res[v] = (max(a for a, _ in errs_d.values()), ms_d, ms_d_plain)
        _line(f"8 kernel D {v}", ok=True, R=Rc, B=cfg.batch_len, S=S, errs_abs_rel=_fmt(errs_d),
              ms=f"{ms_d:.4f}", plain_ms=f"{ms_d_plain:.3f}")

    # ---- 9. the CMA path: each variant's full experiment, counted
    counters = (cma_dp_kernel, cma_chunked_frame, vae_dp_frame_train, vae_dp_loss_and_grad)
    cma_launches = {}
    n_cma = cfg.n_frame_max  # = the flagship frame, so `sim` serves both paths
    n_eval = n_cma - 2 * cfg.n_cut
    for v, (mode, lr_v, band) in CMA_VARIANTS.items():
        cfg_v = dataclasses.replace(cfg, loss_type=v, lr=lr_v)
        path_kernel = cma_dp_kernel if v == "CMA" else cma_chunked_frame
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train_dp.run_cma_dp(cfg_v, seed=0, device=DEVICE, runs=Rc, use_pallas=mode)
        torch.cuda.synchronize()
        wall_v = time.perf_counter() - t0
        counts = {c.__name__: c.launches for c in counters}
        name_v = path_kernel.__name__
        if counts[name_v] != cfg.num_frames or sum(counts.values()) != cfg.num_frames:
            raise AssertionError(f"{v}: launches {counts}, expected {cfg.num_frames} of {name_v}")
        cma_launches[v] = counts[name_v]
        for k in ("ser", "mi", "var_est", "taps"):
            if not np.all(np.isfinite(np.asarray(res[k].cpu() if k == "taps" else res[k]))):
                raise AssertionError(f"{v}: non-finite {k}")
        if res["ser"].shape != (Rc, 4, cfg.num_frames) or res["mi"].shape != (Rc, 2, cfg.num_frames):
            raise AssertionError(f"{v}: result shapes {res['ser'].shape} {res['mi'].shape}")
        const_ser = float(res["ser"][:, :2, -20:].mean())
        if not band[0] <= const_ser <= band[1]:
            raise AssertionError(f"{v}: last-20-frame constellation SER {const_ser:.5f} outside {band}")

        # per-frame breakdown at this path's shapes (CUDA events)
        st = {}
        step_v = cfg.batch_len if v == "CMAbatch" else cfg.flex_step
        wfn_v = train_dp._margin_weight_fn(n_eval, dev)

        def channel_v():
            st["ch"] = sim(gen, thetas[0], Rc)  # the flagship's 10,000-symbol channel

        def kernel_v():
            if v == "CMA":
                st["k"] = cma_dp_kernel(st["ch"][0], cfg.R, h_c, lr_v, cfg.sps)
            else:
                st["k"] = cma_chunked_frame(st["ch"][0], cfg.R, h_c, lr_v, cfg.batch_len, step_v,
                                            cfg.sps)

        def evaluate_v():
            train_dp._finish_cma_frame(st["k"][0], st["k"][2], st["ch"][1], st["ch"][2], const, amps,
                                       P, var, cfg.n_cut, wfn_v)

        ms_ch_v, ms_k_v, ms_ev_v = _time_ms(channel_v), _time_ms(kernel_v), _time_ms(evaluate_v)
        sym_s_v = Rc * cfg.num_frames * n_cma / wall_v
        _line(f"9 CMA path {v}", ok=True, runs=Rc, use_pallas=repr(mode), lr=lr_v,
              frames=cfg.num_frames, launches=cma_launches[v], const_ser_last20=f"{const_ser:.5f}",
              band=band, soft_ser_last20=f"{float(res['ser'][:, 2:, -20:].mean()):.5f}",
              mi_last20=f"{float(res['mi'][:, :, -20:].mean()):.4f}", wall_s=f"{wall_v:.3f}",
              sym_per_s=f"{sym_s_v:.0f}", channel_ms=f"{ms_ch_v:.3f}", kernel_ms=f"{ms_k_v:.3f}",
              eval_ms=f"{ms_ev_v:.3f}", frame_wall_ms=f"{1e3 * wall_v / cfg.num_frames:.3f}",
              card=repr(card))
        for c in counters:
            c.launches = 0

    awgn_kernels = _awgn_phases(card)

    kernels = {"kernels": [
        {"name": "vae_dp_frame_train", "route": "cuda",
         "source": "vae_equalizer_tpu_torch/csrc/dp_kernels.cu",
         "replaces": "vae_equalizer_tpu/ops/frame_kernel.py:1024", "launches": launches_b,
         "max_abs_err": b_err, "ms": ms_b, "plain_ms": ms_b_plain},
        {"name": "cma_dp_kernel", "route": "cuda",
         "source": "vae_equalizer_tpu_torch/csrc/cma_kernels.cu",
         "replaces": "vae_equalizer_tpu/ops/cma_kernel.py:128", "launches": cma_launches["CMA"],
         "max_abs_err": max(a for a, _ in errs_c.values()), "ms": ms_c, "plain_ms": ms_c_plain},
    ] + [
        {"name": f"cma_chunked_frame[{v}]", "route": "cuda",
         "source": "vae_equalizer_tpu_torch/csrc/cma_kernels.cu",
         "replaces": "vae_equalizer_tpu/ops/cma_frame_kernel.py:404", "launches": cma_launches[v],
         "max_abs_err": d_res[v][0], "ms": d_res[v][1], "plain_ms": d_res[v][2]}
        for v in ("CMAbatch", "CMAflex")
    ] + awgn_kernels, "step_body_checked": [
        {"name": "vae_dp_loss_and_grad", "route": "cuda",
         "source": "vae_equalizer_tpu_torch/csrc/dp_kernels.cu",
         "replaces": "vae_equalizer_tpu/ops/elbo_kernel.py:361",
         "launches": vae_dp_loss_and_grad.launches,
         "max_abs_err": max(errs_a["gw"][0], errs_a["gh"][0]), "ms": ms_a, "plain_ms": ms_a_plain},
    ]}
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
