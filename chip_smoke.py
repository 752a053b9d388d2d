#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives the port's paths through their hand-written CUDA kernels, after
building them from ``csrc/`` and holding each kernel against its plain
PyTorch version at its path's shapes: the flagship DP VAE online-training
experiment (``vae_equalizer_tpu_torch.train.train_vae_dp``, DpConfig()
defaults: 64-QAM, M = 25, bl = 100, 170 frames x 10,000 symbols, 8 runs) in
its frame mode (kernel B) and its per-step mode (kernel A), the CMA /
CMAbatch / CMAflex baselines on the same channel (``run_cma_dp``, 5 runs),
the AWGN VAE-LE experiment (``train_vae_le_awgn``, 20 runs), the AWGN VAE-NN
experiment (``train_vae_nn_awgn``, Net and Net_BN, 8 runs), the streaming DP
receiver (``models.streaming.StreamingReceiver``, kernel B adapting each
block and kernel E equalizing it) and VAEflex
(``train_vae_flex_dp``, 8 runs, kernel B with stride_sym = 10, and kernel A
per window), kernel B's per-run constants and the Eval_run_DP sweep driver
(``drivers/eval_run_dp.py``: the lr, SNR and nu axes batched into the runs
of one kernel B launch per frame), the AWGN CMA experiment
(``run_cma_awgn``, 8 runs, kernel I), the LMMSE / DFE sweep
(``train.dfe.run_lmmse_dfe``, kernel J), the four AWGN drivers, and the dp x
sp sharded VAE and VAEflex runners (``parallel/seqpar.py``) on gloo ranks
sharing the card, and every runner's runs split over two such ranks (run
sharding, ``train/batching.py``). One line per phase:

  1. device    card name and power limit (nvidia-smi)
  2. build     nvcc build of kernels A-J (one nvcc per source, in parallel),
               seconds, ptxas resource use
  3. kernel A  vs plain (one minibatch of R = 8 runs, one launch), errors
               and CUDA-event times
  4. kernel B  vs plain: (a) a 3-minibatch frame, R = 8, across the lr
               halving; (b) a full 100-step frame; times; the block's
               clock64() cycles per step and phase
  5. main path the full VAE experiment; launch counts (kernels B and K, one
               each a frame), soft SER band, MI, speed
  6. breakdown per-frame channel / kernel B / eval times
 6b. kernel K  vs the plain eval on kernel B's streams of a flagship frame
               (R = 8, from the state after 20 trained frames): SERs, shift
               and r equal, MI within 1e-6 bits; two launches bit for bit;
               the whole call's and the launch's times beside the bound; the
               plain version's time and kernel count (torch.profiler); one K
               launch a frame on a 12-frame run, looped and replayed, counted;
               the block's clock64() cycles per phase (eval_clocks). Every
               counted DP frame-mode path below counts K's launches too
  7. kernel C  vs plain: a whole 10,000-symbol CMA frame, R = 5; two launches
               bit for bit; the whole call's and the launch's times; the
               block's clock64() cycles per symbol and phase
  8. kernel D  vs plain: a whole CMAbatch and a whole CMAflex frame, R = 5;
               the same checks, times and cycles per chunk and phase
  9. CMA path  the three 170-frame CMA experiments, R = 5: launch counts,
               constellation SER band, speed; per-frame channel / kernel /
               eval times
 10. kernel F  vs plain: one 350-symbol AWGN minibatch, 64-QAM, R = 20; two
               launches bit for bit; the whole call's and the launch's times;
               the block's clock64() cycles per phase (siso_step_clocks)
 11. kernel G  vs plain: (a) 2 epochs from a near-Dirac start; (b) 10 epochs
               from the state after 50 trained epochs, launched twice (bit
               for bit), and its cycles per step and phase (siso_clocks); the
               whole 1,500-step experiment timed against the plain engine
 12. AWGN path the full AWGN VAE-LE experiment (``train_vae_le_awgn``,
               AwgnVaeLeConfig(): 64-QAM, h1, 24 dB, 500 epochs, 250 evals),
               R = 20, with use_pallas="frame" (kernel G) and True (kernel F):
               launch counts, last-25-evals SER band, final MI, speed;
               channel / kernel / eval split
 13. kernel H  vs plain, Net and Net_BN, R = 8, full width: (a) 2 epochs from
               a perturbed start; (b) 10 epochs from the state after 50
               trained epochs; a 20-epoch slice timed against the plain engine,
               launched twice on the same inputs (bit for bit), and its
               clock64() cycles per step and phase (nn_clocks)
 14. VAE-NN    the full VAE-NN experiment (AwgnVaeNnConfig(): 64-QAM, h1,
     path      24 dB, 500 epochs x 13 steps, 250 evals), Net then Net_BN, R = 8,
               use_pallas="frame": one kernel H launch each, last-25-evals SER
               band, final MI; channel / kernel / eval split
 15. kernel E  vs plain: one output pass at the streaming shapes, sps 2 and 1;
               two launches bit for bit; the whole call's and the launch's
               times beside an empty launch; the block's clock64() cycles per
               phase (butterfly_clocks)
 16. streaming DpConfig()'s channel as one continuous stream of 120 blocks of
     path      2,000 symbols through StreamingReceiver(adapt=True,
               use_pallas=True), adapt route B: one kernel B launch (the
               block's 20 Adam steps) and one kernel E launch per block,
               last-10-block SER band; the receiver's own ms per block (CUDA
               events around rxr.step), split into adapt / output; B's launch
               alone; the autograd route (use_pallas=False) for 3 blocks, its
               ms per block; (b) route B vs the autograd route on block 0 from
               the Dirac start; (c) kernel B at R = 1 vs plain from the
               stream's final state, times and cycles per phase
 17. per-step  train_vae_dp(use_pallas=True), the full 170 frames, R = 8: one
     path      kernel A launch per minibatch (17,000), soft SER band, MI;
               channel / kernel A / Adam / eval split; use_pallas=False
               (autograd) for 2 frames, its frame time
 18. kernel B  stride_sym = 10 vs plain: (a) 3 windows; (b) a full
     stride    990-window frame from a warm state; times; cycles per phase
 19. VAEflex   train_vae_flex_dp(use_pallas="frame"), 170 frames, R = 8: one
     path      kernel B and one kernel K launch per frame, soft SER and MI in
               the JAX band; channel / kernel B / eval split; kernel K vs the
               plain eval on a frame through the trained taps (crop, margin
               mask): SERs, shift and r equal, MI within 1e-6 bits
 20. VAEflex   use_pallas=True (kernel A per window) against "frame" on shared
     per-step  draws, 5 frames from phase 19's taps; frame times
 21. kernel B  per-run lr / var / nu_sc / P, R = 8 (8 lr, SNR 16-23 dB, nu 0 and
     per run   0.0270955): (a) a 3-minibatch frame across the lr halving vs
               plain; (b) constant vectors vs the shared form and rows vs
               single-run calls, bit for bit; (c) stream_bf16 vs float32; times;
               (d) kernel K vs the plain eval on per-run float32 and bfloat16
               streams: SERs, shift and r equal, MI within 1e-6 bits
 22. lr sweep  the Eval_run_DP driver (``drivers/eval_run_dp.py``) at its
               defaults with --pallas-frame --batch-lr-axis: 3 lr x 5 iters =
               15 runs, one kernel B launch per frame; per-point soft SER in
               the JAX band; the unbatched sweep (3 calls of 5 runs) point for
               point; the .mat's keys and shape
 23. SNR curve --batch-snr-axis over 16-23 dB at lr 2.5e-3: 40 runs, one kernel
               B launch per frame; the SER-vs-SNR curve against JAX's, monotone;
               var_real per point
 24. nu sweep  --batch-nu-axis over nu 0 and 0.0270955: 10 runs; soft SER and
               MI against JAX's; each of 22-24 with wall, symbols/s and a
               per-frame channel / kernel B / eval split
 25. kernel I  vs plain: 2 epochs of AwgnCmaConfig() (8,000 dependent symbols),
               R = 8; two launches bit for bit; the whole call's and the
               launch's times; lane 0's clock64() cycles per symbol and phase
 26. AWGN CMA  run_cma_awgn(AwgnCmaConfig(), runs=8): 500 epochs x 4,000
     path      symbols, 250 evals, one kernel I launch; every run's last-25-
               evals SER in the JAX band, final MI; wall, symbols/s and a
               channel / kernel I / eval split
 27. kernel J  vs plain: the 40 decision chains (8 SNRs x 5 epochs x 128,000
               symbols) of LmmseDfeConfig(), decisions bit for bit; times
 28. DFE path  run_lmmse_dfe(LmmseDfeConfig()): one kernel J launch; per SNR
               the LMMSE and DFE SER against JAX's; wall, symbols/s
 29. drivers   eval_run_shaping_cma, eval_run_shaping_vaele --pallas-frame,
               eval_run_vaenn --pallas-frame and eval_run_dfe with --quick on
               the card: JSONL and .mat written, one I / G / H / J launch each
 30. resume    checkpoint/resume inside a point: each run uninterrupted (its
               default draws on a CUDA generator, run twice), then with a
               checkpoint, killed after a save, then resumed; resumed and
               uninterrupted bit for bit (every history, the final params or
               taps), the resumed call launching only the frames left: (a)
               train_vae_dp(DpConfig(num_frames=12), runs=8, "frame"), K = 5,
               killed at frame 8, B 7 times; (b) the same call SIGKILLed in a
               child process after its first save, resumed here; (c) run_cma_dp
               CMA (kernel C), R = 5, 12 frames, K = 5; (d) train_vae_le_awgn(
               num_epochs=20, runs=20, use_pallas=True) (F), K = 6, killed at
               epoch 14; (e) run_cma_awgn(num_epochs=40, runs=8), K = 10: kernel I
               in 4 segments against one launch, killed in segment 3; per
               sub-phase the save points, bytes and ms per save
 31. graphs    CUDA-graph replay (``compiled`` / ``chunk_frames`` /
               ``timings``), each held to its loop mode bit for bit (max
               abs diff 0.0): (a) the flagship, 170 frames, R = 8, loop /
               compiled / loop / compiled walls in turns, compiled with
               timings (compile_s, run_s) and chunk_frames = 16, B 170
               launches counted as replays; the device's busy share over 20
               frames, loop and replay (torch.profiler); (b) compiled with
               timings against the loop: flagship True (A), VAEflex "frame"
               (B), CMA (C), CMAbatch and CMAflex (D) at 12 frames, the AWGN
               VAE-LE True (F) at its 500 epochs, the VAE-NN loop (Net) at
               12 epochs, the AWGN CMA (I) at 120; (c) timings on the G and
               H experiments (100 epochs): the keys, run_s at most the
               plain run's wall, the same result; (d) eval_run_dp --quick
               --compiled and --frames-per-call 4: every point's SER equal
 32. seqpar    sequence parallelism (``parallel/seqpar.py``), every rank a gloo
               rank sharing the card, at the flagship's width: (a) one sharded
               step, dp 1 x sp 2 and dp 2 x sp 2, against the unsharded
               autograd step (loss, var_est, raw gradients and their ratio to
               the unsharded ones, params after Adam); (b) train_vae_dp_sharded
               and train_vae_flex_dp_sharded, R = 2, 6 frames, dp 1 x sp 2,
               against the unsharded autograd runners frame by frame (SER
               within 2e-3, or 4x the distance at which the unsharded runner
               parts from itself with w moved by 1e-7), every frame finite;
               the wall per frame of both and the sharded training's share in
               collectives; (c) dryrun_multichip(2); the path launches none of
               the kernels A-J (the sharded step is autograd, as in JAX)
 33. seqpar    the sharded runners' options, the VAE at 32b's shapes (R = 2,
     options   6 frames, dp 1 x sp 2): (a) compiled and chunk_frames = 2,
               each bit for bit (max abs diff 0.0) with 32b's loop result;
               (b) checkpoint_every = 2, SIGKILLed in a child process (its
               process group: both ranks) after frame 3, resumed here, bit
               for bit with 32b's result; ms per save, split into the gather
               and the write, and the file's bytes; none of A-J launched in
               (a) or (b); (c) utils.profiling on kernel B (phase 4b's frame,
               R = 8): timed's median within 2x of 4b's time, and trace's
               Chrome trace naming vae_dp_frame_kernel; (c) runs before
               phase 32 (after profiler sessions and then process groups,
               torch.profiler recorded no CUDA kernel in this process)
 34. run       run sharding (``train/batching.py``): each runner's runs split
     sharding  over two gloo ranks sharing the card, every rank launching its
               kernels on its share, held to the unsharded run bit for bit
               (max abs diff 0.0) with each rank's launches counted: (a) the
               flagship at full width and depth (170 frames, R = 8: B 170
               times per rank at R = 4) against phase 5, its soft SER band
               and MI, both ranks' walls against phase 5's and the spawn's
               seconds; (b) its compiled mode (each rank replays its graph);
               (c) A (VAE True), C, D (CMA, CMAbatch, CMAflex, R = 6), G and F
               (VAE-LE, R = 20), H (VAE-NN Net, R = 8), I (AWGN CMA, R = 8) at
               12 frames or 12-40 epochs against their unsharded runs; the
               ranks load this process's kernel build; (d) the sharded
               flagship killed after 2 frames, resumed with no mesh: 168 B
               launches, bit for bit with phase 5

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
NN_RUNS = 8
# Per run, the mean SER of the last 25 evals of the VAE-NN experiment
# (AwgnVaeNnConfig()). The JAX package on the CPU (tools/jax_bands.py, PERF.md
# §6): Net, runs 4 at keys 0 and 1, 8 runs, none stuck, 0.009941-0.011235,
# final MI 5.9422-5.9543; Net_BN, 16 runs (keys 0, 1, 10, 11, 20, 21, ..., 70,
# 71, runs=None), 1 stuck, converged 0.010810-0.011935, final MI
# 5.9387-5.9550. Band = each spread widened 2x about its middle; MI floor =
# the lowest final MI less the spread. {batchnorm: (band, MI floor)}
NN_BANDS = {False: ((0.00929, 0.01188), 5.93), True: ((0.01025, 0.01250), 5.92)}
NN_MAX_STUCK = 2  # of NN_RUNS (a stuck run: last-25 SER above AWGN_STUCK_SER)
NN_WARM_EPOCHS = 50
NN_TIMED_EPOCHS = 20  # kernel H vs its plain engine, timed over this slice
# The streaming receiver on DpConfig()'s channel (64-QAM, 23 dB, h0, CD/PMD,
# theta = pi/10), 2,000-symbol blocks: the JAX receiver on the CPU
# (tools/jax_bands.py stream, keys 0 and 1, 200 blocks) settles after 51 and 53
# blocks; its 10-block mean SER over blocks 60-200 spans 0.00860-0.01292 and
# its single blocks 0.00556-0.01872. Band = each widened 2x about its middle.
STREAM_BLOCKS = 120
STREAM_BAND = (0.00644, 0.01508)  # mean SER of the last 10 blocks
STREAM_BLOCK_MAX = 0.0253  # each of the last 10 blocks
# VAEflex (train_vae_flex_dp(DpConfig()): windows of 100 every 10, 990 per
# frame). The JAX package on the CPU (tools/jax_bands.py vaeflex, keys 0-7,
# runs 2, 16 runs, PERF.md): per run the last-20-frame soft SER
# 0.022265-0.023367 and the final MI (mean of the pols) 5.8274-5.8785 bits.
# Bands for the mean over runs = each spread widened 2x about its middle,
# rounded outward (the SER band holds the reference's 0.0230); every run's MI
# above the lowest less the spread.
VAEFLEX_SER_BAND = (0.02171, 0.02392)
VAEFLEX_MI_BAND = (5.801, 5.905)
VAEFLEX_MI_FLOOR = 5.77
FLEX_CHECK_FRAMES = 5  # VAEflex use_pallas=True against "frame", phase 20
# Phases 22-24: the JAX package's batched Eval_run_DP sweeps on a TPU at these
# defaults (PARITY_RESULTS.md:1005-1084; accuracy only, its times are not the
# port's). Per point, the mean over iters of the last-20-frame soft SER.
SWEEP_TOL = 0.003
LR_SWEEP_SER = {2.5e-3: 0.0314, 2e-3: 0.0305, 3e-3: 0.0323}  # :1011, within +-SWEEP_TOL
SNR_CURVE_SER = {16: 0.3281, 17: 0.2571, 18: 0.1943, 19: 0.1391, 20: 0.0956, 21: 0.0644,
                 22: 0.0436, 23: 0.0315}  # :1023-1024, within max(SWEEP_TOL, 10 %)
# nu -> (soft SER within +-SWEEP_TOL, floor of the last-20-frame MI); the heavy-
# shaping points 0.0872449 and 0.1222578 diverge in every mode (:1072-1084)
NU_SWEEP = {0.0: (0.0313, 5.70), 0.0270955: (0.0129, 5.53)}  # :1074-1075
# Phases 25-26: the AWGN CMA experiment (AwgnCmaConfig(): 64-QAM, h1, 22 dB,
# 500 epochs of 4,000 symbols, 250 evals), kernel I. The JAX package on the CPU
# (tools/jax_bands.py cma_awgn, keys 0-7, runs 4: 32 runs, PERF.md): per run
# the mean SER of the last 25 evals 0.064896-0.068068 (mean 0.066477; the
# reference gave 0.06639, JAX 0.06700, PARITY_RESULTS.md:40-48) and the final
# MI 3.7007-4.0532 bits. Band = the SER spread widened 2x about its middle,
# rounded outward, for every run; MI floor = the lowest less the spread.
CMA_AWGN_RUNS = 8
CMA_AWGN_BAND = (0.06330, 0.06966)
CMA_AWGN_MI_MIN = 3.34
CMA_AWGN_CHECK_EPOCHS = 2  # kernel I vs its plain version (8,000 dependent symbols)
# Phases 27-28: run_lmmse_dfe(LmmseDfeConfig()) (PCS 64-QAM nu = 0.0270955, h1,
# 8 SNRs x 5 epochs x 128,000 symbols), kernel J. The JAX package's mean SER
# over the epochs per SNR, (LMMSE, DFE) (PARITY_RESULTS.md:64-69); the port's
# must lie within 3 sqrt(DFE_DISPERSION 2 p (1 - p) / 640,000) of each (two
# independent estimates of 640,000 symbols). The per-frame SER varies more than
# a binomial count: error bursts through the feedback state, the measured noise
# power and the sync. Over 13 sweeps of this configuration on the CPU
# (tools/dfe_dispersion.py: the port at seeds 0-9, JAX at keys 0-2; PERF.md)
# the pooled per-epoch variance was 0.96-2.46x the binomial at each point, and
# with the binomial tolerance alone the worst point of those sweeps sat at 1.45x
# its tolerance; with the variance x4, at 0.72x.
DFE_DISPERSION = 4.0
DFE_JAX_SER = {15: (0.3170, 0.3309), 16: (0.2420, 0.2505), 17: (0.1727, 0.1740),
               18: (0.1130, 0.1080), 19: (0.0680, 0.0596), 20: (0.0357, 0.0278),
               21: (0.0159, 0.0108), 22: (0.0061, 0.0034)}
# Published peaks of one H100 SXM (NVIDIA's datasheet) for each
# kernel's bound: float32 outside the tensor cores and HBM.
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12


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
    are within `tol` (relative) — a tie to float32 rounding. out (..., R, 2,
    2, bl); var (2,) or per run (R, 2), nu_sc a float or (R,)."""
    import torch

    mism = dec != dec_ref
    if not bool(mism.any()):
        return 0, 0
    if torch.is_tensor(nu_sc):
        nu_sc = nu_sc.reshape(nu_sc.shape + (1, 1, 1, 1))
    met = (out[..., None, :] - amps[:, None]) ** 2 / (2 * var.reshape(var.shape[:-1] + (2, 1, 1, 1))) \
        + nu_sc * (amps * amps)[:, None]
    two = met.topk(2, dim=-2, largest=False).values
    gap = (two[..., 1, :] - two[..., 0, :]) / two[..., 0, :].abs().clamp_min(1.0)
    non_tie = mism & (gap > tol)
    if bool(non_tie.any()):
        raise AssertionError(f"dec: {int(non_tie.sum())} mismatches away from ties")
    return int(mism.sum()), int(mism.numel())


def _check_b3(got, want, amps, var, nu_sc, eq_atol, errs) -> tuple:
    """Kernel B against its plain version over a few minibatches (phases 4a,
    18a, 21a): w, h, losses, var_est at rtol 1e-4 over an absolute 3e-7; the
    Adam moments (raw gradients of scale ~1e1-1e2, where 3e-7 is below one
    float32 ulp) over 1e-5 of their scale; out, s1 over 1e-6 and eq over
    ``eq_atol``; mm over 1e-4 (near-zero minima carry the output's absolute
    error times the 1/(2 var) gain); decisions differ only at ties. Records
    into errs; returns the tie mismatches (count, of)."""
    names = ("w", "h", "opt", "losses", "var_est", "out", "dec", "eq", "mm", "s1")
    g, w = dict(zip(names, got)), dict(zip(names, want))
    for k in ("w", "h", "losses", "var_est"):
        _check(k, g[k], w[k], 1e-4, 3e-7, errs)
    for k in ("mw", "vw", "mh", "vh"):
        _check(k, g["opt"][k], w["opt"][k], 1e-4, 1e-5 * float(w["opt"][k].abs().max()), errs)
    for k in ("out", "s1"):
        _check(k, g[k], w[k], 1e-4, 1e-6, errs)
    _check("eq", g["eq"], w["eq"], 1e-4, eq_atol, errs)
    _check("mm", g["mm"], w["mm"], 1e-4, 1e-4, errs)
    return _dec_ties_only(g["dec"], w["dec"], w["out"], amps, var, nu_sc)


def _clocks_kv(clocks: dict) -> dict:
    """A kernel's phase clocks (ops/frame_kernel.py: frame_clocks,
    ops/nn_frame_kernel.py: nn_clocks) as line fields: cycles per step in
    all, and per phase with its share."""
    total = sum(clocks.values())
    return {"cycles_per_step": f"{total:.0f}",
            "phase_cycles": ",".join(f"{k}:{v:.0f}({100 * v / total:.1f}%)" for k, v in clocks.items())}


def _nbytes(*objs) -> int:
    """Bytes of every tensor in objs (tuples, lists and dicts walked): each
    input read once, each output written once."""
    import torch

    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            total += _nbytes(*o)
        elif isinstance(o, dict):
            total += _nbytes(*o.values())
    return total


def _bound(flops: float, nbytes: int) -> dict:
    """The least time the card could take: the larger of FLOPs at the f32 peak
    and bytes at the HBM rate."""
    t_ops, t_bytes = 1e3 * flops / F32_FLOPS, 1e3 * nbytes / HBM_BYTES
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


# FLOP counts of the kernels' work (2 per multiply-add, 1 per other
# arithmetic op, exp or log), per run and step, from the shapes:
def _elbo_flops(n_samp: int, m: int, n_lev: int, pols: int) -> float:
    """The ELBO from the posteriors and its gradient back to them: the D conv
    of E_q[x] through h (per out-pol 2 re/im x n_eff x pols in-pols x 2 I/Q x
    (m + 1) / 2 nonzero taps), its two adjoints (to E_q[x] and to h), and per
    posterior ~12 ops (moments, KL, dL/dq)."""
    n_eff = n_samp - (m - 1)
    conv = pols * 2 * n_eff * pols * 2 * ((m + 1) // 2)
    return 2 * 3 * conv + pols * 2 * (n_samp // 2) * n_lev * 12


def _dp_step_flops(n_sym: int, m: int, n_lev: int) -> float:
    """Kernels A/B: butterfly (4 outputs x 4 rows x m taps) forward and gw,
    the softmin demapper and its VJP, the DP ELBO."""
    return 2 * 2 * 4 * n_sym * 4 * m + 4 * n_sym * n_lev * 12 + _elbo_flops(2 * n_sym, m, n_lev, 2)


def _cma_chunked_flops(n_sym: int, m: int, batch_len: int, symb_step: int, n_full: int) -> float:
    """Kernel D, one run over a frame: every symbol's butterfly output (4
    outputs x 4m multiply-adds) and error (~10 ops); the partial sums
    sum_t e_t inc_t of the B symbols that seed the ring and of every full
    chunk (8m tap entries x 5 ops per symbol: the increment, times e, added);
    the n_full + 1 ring sums and tap updates (8m entries x (B/S + 1) ops)."""
    n_slots = batch_len // symb_step
    return n_sym * (2 * 4 * 4 * m + 10) + (batch_len + n_full * symb_step) * 8 * m * 5 + \
        (n_full + 1) * 8 * m * (n_slots + 1)


def _eval_flops(n_sym: int, n_lev: int, corr_len: int) -> float:
    """Kernel K, one run over a frame of n_sym symbols: the two sync searches
    (2 searches x 8 (comp, b, i) x 21 shifts x corr_len multiply-adds), then
    per symbol and pol the soft SER (8 variants x 3 ops), the MI (8 traces x
    12 ops: the metric's 6, exp, the division, the guard, log2 and the
    weighted sum; the prior 3), the rescale (2), the constellation SER's 4
    (n_lev - 1) level comparisons and 8 variants x 4 ops, and the magnitudes
    (8)."""
    per_symbol = 8 * 3 + 8 * 12 + 3 + 2 + 4 * (n_lev - 1) + 8 * 4 + 8
    return 2 * 8 * 21 * corr_len * 2 + 2 * n_sym * per_symbol


def _launch_alone_ms(fn, launcher: str, reps: int = 5, build_mod=None) -> float:
    """Median CUDA-event time of the kernel launch alone inside fn(): events
    recorded on the stream right around the call of the library's entry point
    ``launcher`` (the wrapper's own work lies outside them), after a warm-up.
    ``build_mod``: the ``ops._build`` module whose libraries fn calls (another
    checkout's, in tools/); this tree's by default."""
    import torch

    if build_mod is None:
        from vae_equalizer_tpu_torch.ops import _build as build_mod

    lib = build_mod.load()
    real, events = getattr(lib, launcher), []

    def timed(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rc = real(*args)
        end.record()
        events.append((start, end))
        return rc

    setattr(lib, launcher, timed)
    try:
        fn()
        torch.cuda.synchronize()
        events.clear()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in events)
    finally:
        setattr(lib, launcher, real)


def _siso_step_flops(n_sym: int, m: int, n_lev: int) -> float:
    """Kernels F/G: the SISO FIR (2 outputs x 2 rows x m taps) forward and gw,
    the demapper and its VJP, the SISO ELBO."""
    return 2 * 2 * 2 * n_sym * 2 * m + 2 * n_sym * n_lev * 12 + _elbo_flops(2 * n_sym, m, n_lev, 1)


def _nn_step_flops(n_sym: int, m: int, n_lev: int, k1: int, batchnorm: bool) -> float:
    """Kernel H: conv1 (C x 2 bl x 2 k1) forward and gW1; conv2 (C x bl x 3C)
    forward, gW2 and its input gradient; ELU / BatchNorm / softmax and their
    VJPs; the SISO ELBO."""
    ch, n_samp = 2 * n_lev, 2 * n_sym
    conv = 2 * (ch * n_samp * 2 * k1) + 3 * (ch * n_sym * 3 * ch)
    return 2 * conv + ch * n_samp * (10 if batchnorm else 4) + ch * n_sym * 12 + \
        _elbo_flops(n_samp, m, n_lev, 1)


def _cma_siso_flops(n_sym: int, m: int) -> float:
    """Kernel I, one run over n_sym symbols: the complex FIR output (4m
    multiply-adds), the error (4 ops) and the tap update (per tap and plane
    2 multiplies, an add, a multiply by 2 lr e and the add: 10m)."""
    return n_sym * (8 * m + 4 + 10 * m)


def _dfe_flops(n_sym: int, k2: int, n_points: int) -> float:
    """Kernel J, one chain over n_sym symbols: the correction (4 K2 multiply-
    adds and 4 ops), the distances (5 ops a point) and the argmin (1 a point)."""
    return n_sym * (8 * k2 + 4 + 6 * n_points)


def _cma_awgn_phases(card: str) -> list:
    """Phases 25-26: kernel I against its plain version, then the AWGN CMA
    experiment, counted (one kernel I launch). Returns I's JSON entry."""
    import numpy as np
    import torch

    from vae_equalizer_tpu_torch.models import dirac_taps_siso
    from vae_equalizer_tpu_torch.ops.cma_siso_kernel import (
        cma_siso_clocks,
        cma_siso_experiment,
        cma_siso_experiment_plain,
    )
    from vae_equalizer_tpu_torch.train import awgn as train_awgn
    from vae_equalizer_tpu_torch.utils import AwgnCmaConfig

    dev = torch.device(DEVICE)
    cfg = AwgnCmaConfig()
    const, sims, amps, P, var = train_awgn._setup(cfg, dev)
    R, M = CMA_AWGN_RUNS, cfg.m_est
    gen = torch.Generator(device=dev)
    gen.manual_seed(2468)
    rng = torch.Generator(device=dev)
    rng.manual_seed(13)
    draws = lambda kind, index, runs: sims[kind].draws(gen, runs)  # noqa: E731
    h0 = dirac_taps_siso(M, dev) + 0.01 * torch.randn((R, 2, M), generator=rng, device=dev)

    # ---- 25. kernel I vs plain: 2 epochs (8,000 dependent symbols), R = 8
    # (rtol 1e-4 with an absolute floor of 1e-6 of each tensor's scale, phase
    # 7's tolerance for C: float32 sums in another order, no Adam to amplify them)
    rx2 = train_awgn._frame_train_data(sims["train"], draws, R, CMA_AWGN_CHECK_EPOCHS)
    i_args = (rx2, h0, cfg.R, cfg.lr, cfg.sps, 1)  # epe 1: a snapshot after each epoch
    got = cma_siso_experiment(*i_args)
    again = cma_siso_experiment(*i_args)
    torch.cuda.synchronize()
    if not all(torch.equal(a_, b_) for a_, b_ in zip(got, again)):
        raise AssertionError("kernel I: two launches on the same inputs differ")
    want = cma_siso_experiment_plain(*i_args)
    errs_i: dict = {}
    for name, g_, w_ in zip(("h", "h_ev", "loss"), got, want):
        _check(name, g_, w_, 1e-4, 1e-6 * float(w_.abs().max()), errs_i)
    ms_i = _time_ms(lambda: cma_siso_experiment(*i_args))
    ms_i_launch = _launch_alone_ms(lambda: cma_siso_experiment(*i_args),
                                   "cma_siso_experiment_launch")
    ms_i_plain = _time_ms(lambda: cma_siso_experiment_plain(*i_args), reps=1, warmup=False)
    n_sym = cfg.n_train
    bound_i = _bound(R * CMA_AWGN_CHECK_EPOCHS * _cma_siso_flops(n_sym, M), _nbytes(i_args[:2], got))
    _line("25 kernel I", ok=True, R=R, epochs=CMA_AWGN_CHECK_EPOCHS, errs_abs_rel=_fmt(errs_i),
          bit_identical=True, ms=f"{ms_i:.3f}", launch_ms=f"{ms_i_launch:.3f}",
          plain_ms=f"{ms_i_plain:.1f}", bound_ms=f"{bound_i['bound_ms']:.6f}",
          **_clocks_kv(cma_siso_clocks(*i_args)), card=repr(card))

    # ---- 26. the AWGN CMA path: the full experiment, one kernel I launch
    n_evals = cfg.num_epochs // cfg.epe
    res, wall = _counted(cma_siso_experiment, 1, lambda: train_awgn.run_cma_awgn(
        cfg, seed=0, device=DEVICE, runs=R))
    for k in ("ser", "mi"):
        if res[k].shape != (R, n_evals) or not np.all(np.isfinite(res[k])):
            raise AssertionError(f"AWGN CMA {k}: shape {res[k].shape} or non-finite values")
    if tuple(res["taps"].shape) != (R, 2, M) or not bool(torch.isfinite(res["taps"]).all()):
        raise AssertionError("AWGN CMA taps: shape or non-finite values")
    ser25 = res["ser"][:, -25:].mean(-1)  # (R,) last-25-evals mean SER per run
    lo, hi = CMA_AWGN_BAND
    mi_last = res["mi"][:, -1]
    if not (np.all((lo <= ser25) & (ser25 <= hi)) and np.all(mi_last > CMA_AWGN_MI_MIN)):
        raise AssertionError(f"AWGN CMA: last-25-evals SER per run {ser25} (band {CMA_AWGN_BAND}), "
                             f"final MI {mi_last} (floor {CMA_AWGN_MI_MIN})")
    # channel / kernel I / eval split at the path's shapes (CUDA events, once each)
    st = {}

    def channel():
        st["rx"] = train_awgn._frame_train_data(sims["train"], draws, R, cfg.num_epochs)

    def kernel():
        st["k"] = cma_siso_experiment(st["rx"], h0, cfg.R, cfg.lr, cfg.sps, cfg.epe)

    var_q = torch.full((1,), var, dtype=torch.float32, device=dev)

    def evaluate():
        train_awgn._batched_evals(n_evals, R, draws, lambda sl, vd: train_awgn._cma_evaluate(
            cfg, st["k"][1][sl], vd, sims["valid"], amps, P, var_q, const.nu_sc))

    ms_ch, ms_k, ms_ev = (_time_ms(f, reps=1, warmup=False) for f in (channel, kernel, evaluate))
    n_train_sym = R * cfg.num_epochs * cfg.n_train
    _line("26 AWGN CMA path", ok=True, runs=R, epochs=cfg.num_epochs, evals=n_evals, launches=1,
          ser_last25_mean=f"{ser25.mean():.6f}", ser_last25_min_max=f"{ser25.min():.6f}/{ser25.max():.6f}",
          band=CMA_AWGN_BAND, mi_final_min=f"{mi_last.min():.4f}", wall_s=f"{wall:.3f}",
          train_sym_per_s=f"{n_train_sym / wall:.0f}", channel_ms=f"{ms_ch:.1f}",
          kernel_i_ms=f"{ms_k:.1f}", eval_ms=f"{ms_ev:.1f}",
          kernel_i_sym_per_s=f"{n_train_sym / (1e-3 * ms_k):.0f}", card=repr(card))
    # no TPU kernel and no single PyTorch call computes this recurrence
    return [{"name": "cma_siso_experiment", "route": "cuda",
             "source": "vae_equalizer_tpu_torch/csrc/cma_kernels.cu",
             "replaces": "none (a lax.scan in JAX): vae_equalizer_tpu/models/cma.py:63",
             "launches": 1, "max_abs_err": max(a for a, _ in errs_i.values()), "ms": ms_i,
             "plain_ms": ms_i_plain, **bound_i}]


def _dfe_phases(card: str) -> list:
    """Phases 27-28: kernel J against its plain version on the main path's 40
    chains, then the LMMSE / DFE sweep, counted (one kernel J launch).
    Returns J's JSON entry."""
    import numpy as np
    import torch

    from vae_equalizer_tpu_torch.ops.dfe_kernel import dfe_clocks, dfe_decide, dfe_decide_plain, dfe_route
    from vae_equalizer_tpu_torch.train import dfe as train_dfe
    from vae_equalizer_tpu_torch.utils import LmmseDfeConfig

    dev = torch.device(DEVICE)
    cfg = LmmseDfeConfig()
    n = cfg.n_valid

    # ---- 27. kernel J vs plain: every chain of the sweep (8 SNRs x 5 epochs),
    # decisions equal bit for bit, on the grid route (64-QAM is an 8 x 8 grid)
    c = train_dfe._dfe_chains(cfg, 97, dev)
    k2 = c["fb"].shape[-1]
    n_chains = c["ff_out"].shape[0] * c["ff_out"].shape[1]
    j_args = (c["ff_out"].reshape(n_chains, 2, n).contiguous(),
              c["fb"].expand(-1, cfg.num_epochs, -1, -1).reshape(n_chains, 2, k2).contiguous(),
              c["points"].contiguous(), c["init_idx"].reshape(n_chains, n).contiguous())
    got = dfe_decide(*j_args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = dfe_decide_plain(*j_args)
    torch.cuda.synchronize()
    ms_j_plain = 1e3 * (time.perf_counter() - t0)
    if not torch.equal(got, want):
        bad = got != want
        raise AssertionError(f"kernel J: {int(bad.sum())} of {bad.numel()} decisions differ from "
                             f"the plain version's (first in chain {int(bad.any(-1).nonzero()[0])})")
    route = dfe_route(j_args[2])
    if route[0] != "grid":
        raise AssertionError(f"kernel J: the sweep's 64-QAM table took the {route[0]} route")
    ms_j = _time_ms(lambda: dfe_decide(*j_args), reps=3)
    ms_j_launch = _launch_alone_ms(lambda: dfe_decide(*j_args), "dfe_decide_launch", 3)
    n_points = c["points"].shape[-1]
    bound_j = _bound(n_chains * _dfe_flops(n - k2, k2, n_points), _nbytes(j_args, got))
    _line("27 kernel J", ok=True, chains=n_chains, symbols=n, k2=k2, points=n_points,
          route=f"{route[0]}({route[1]}x{route[1]})", bit_identical=True, ms=f"{ms_j:.3f}",
          launch_ms=f"{ms_j_launch:.3f}", plain_ms=f"{ms_j_plain:.1f}",
          bound_ms=f"{bound_j['bound_ms']:.6f}", **_clocks_kv(dfe_clocks(*j_args)), card=repr(card))

    # ---- 28. the LMMSE / DFE path: 8 SNRs x 5 epochs, one kernel J launch
    res, wall = _counted(dfe_decide, 1, lambda: train_dfe.run_lmmse_dfe(cfg, seed=0, device=DEVICE))
    n_snr = len(train_dfe.SNR_VEC)
    for k in ("ser_mmse", "ser_dfe"):
        if res[k].shape != (n_snr, cfg.num_epochs) or not np.all(np.isfinite(res[k])):
            raise AssertionError(f"DFE {k}: shape {res[k].shape} or non-finite values")
    n_sym = cfg.num_epochs * n
    rows, bad = [], []
    for i, snr in enumerate(res["snrs"]):
        for j, name in enumerate(("ser_mmse", "ser_dfe")):
            p_ref = DFE_JAX_SER[int(snr)][j]
            got_p = float(res[name][i].mean())
            tol = 3 * float(np.sqrt(DFE_DISPERSION * 2 * p_ref * (1 - p_ref) / n_sym))
            rows.append(f"{int(snr)}:{name[4:]}={got_p:.5f}")
            if abs(got_p - p_ref) > tol:
                bad.append(f"SNR {snr} {name}: {got_p:.5f} vs JAX {p_ref} (tolerance {tol:.5f})")
    if bad:
        raise AssertionError("; ".join(bad))
    _line("28 DFE path", ok=True, snrs=n_snr, epochs=cfg.num_epochs, symbols=n, launches=1,
          ser=",".join(rows), wall_s=f"{wall:.3f}", sym_per_s=f"{n_snr * n_sym / wall:.0f}",
          card=repr(card))
    return [{"name": "dfe_decide", "route": "cuda",
             "source": "vae_equalizer_tpu_torch/csrc/dfe_kernel.cu",
             "replaces": "none (a lax.scan in JAX): vae_equalizer_tpu/models/lmmse_dfe.py:91",
             "launches": 1, "max_abs_err": 0.0, "ms": ms_j, "plain_ms": ms_j_plain, **bound_j}]


def _drivers_phase(card: str) -> None:
    """Phase 29: the four AWGN drivers with --quick on the card, each counted:
    its JSONL and .mat written, the CMA driver through kernel I, the VAE-LE
    and VAE-NN drivers' --pallas-frame through G and H, the DFE driver
    through J (one launch each: the quick sweeps have one grid point)."""
    import glob
    import os
    import shutil
    import tempfile

    from vae_equalizer_tpu_torch.drivers import (
        eval_run_dfe,
        eval_run_shaping_cma,
        eval_run_shaping_vaele,
        eval_run_vaenn,
    )
    from vae_equalizer_tpu_torch.ops.cma_siso_kernel import cma_siso_experiment
    from vae_equalizer_tpu_torch.ops.dfe_kernel import dfe_decide
    from vae_equalizer_tpu_torch.ops.nn_frame_kernel import vae_nn_experiment_train
    from vae_equalizer_tpu_torch.ops.siso_frame_kernel import vae_siso_experiment_train

    tmp = tempfile.mkdtemp(prefix="chip_smoke_drivers_")
    try:
        walls = {}
        for name, mod, extra, kern, jsonl in (
                ("shaping_cma", eval_run_shaping_cma, [], cma_siso_experiment, "sweep_*.jsonl"),
                ("shaping_vaele", eval_run_shaping_vaele, ["--pallas-frame"],
                 vae_siso_experiment_train, "sweep_*.jsonl"),
                ("vaenn", eval_run_vaenn, ["--pallas-frame"], vae_nn_experiment_train,
                 "sweep_*.jsonl"),
                ("dfe", eval_run_dfe, [], dfe_decide, "lmmse_dfe.jsonl")):
            out = os.path.join(tmp, name)
            mat, wall = _counted(kern, 1, lambda mod=mod, extra=extra, out=out: mod.main(
                ["--quick", "--device", DEVICE, "--out", out, *extra]))
            if not (os.path.exists(mat) and glob.glob(os.path.join(out, jsonl))):
                raise AssertionError(f"eval_run_{name}: no .mat or JSONL in {out}")
            walls[name] = f"{wall:.2f}"
        _line("29 drivers", ok=True, quick_wall_s=",".join(f"{k}:{v}" for k, v in walls.items()),
              card=repr(card))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class _Kill(RuntimeError):
    """Raised from a run's ``progress`` (or a wrapper) to kill it after a save."""


def _killer(at: int):
    def progress(i, m):
        if i == at:
            raise _Kill(f"killed at {at}")
    return progress


def _max_diff(got, want) -> float:
    """Largest |got - want| over every array, tensor and number of two
    runner results (nested dicts); inf where shapes differ."""
    import numpy as np
    import torch

    if isinstance(want, dict):
        if sorted(got) != sorted(want):
            return float("inf")
        return max((_max_diff(got[k], want[k]) for k in want), default=0.0)
    g, w = (torch.as_tensor(x).detach().cpu().double().numpy() for x in (got, want))
    if g.shape != w.shape:
        return float("inf")
    if np.array_equal(g, w, equal_nan=True):
        return 0.0
    d = np.abs(g - w)
    return float(d.max()) if np.isfinite(d).all() else float("inf")


class _SaveTimer:
    """Records every ``Checkpoint.save`` made inside the block: ``.saves``,
    (frame or epoch saved at, milliseconds of the save: the device-to-host
    copy and the file write)."""

    def __enter__(self):
        from vae_equalizer_tpu_torch.train.harness import Checkpoint

        self.cls, self.real, self.saves = Checkpoint, Checkpoint.save, []

        def timed(ck, done, *a, **k):
            t0 = time.perf_counter()
            self.real(ck, done, *a, **k)
            self.saves.append((done, 1e3 * (time.perf_counter() - t0)))

        Checkpoint.save = timed
        return self

    def __exit__(self, *exc):
        self.cls.save = self.real


def _resume_case(label: str, card: str, call, full, rerun_diff: float, ckpt, every: int,
                 kill: dict, path_kernel, launches_left, also_left=lambda f: (), **kv) -> None:
    """One sub-phase of phase 30: ``call(checkpoint=, checkpoint_every=,
    **kill)`` dies with ``_Kill`` after a save; the resumed call, counted,
    launches ``path_kernel`` ``launches_left(resumed_from)`` times, each
    (kernel, count) of ``also_left(resumed_from)`` count times, and nothing
    else, and its result must be within ``rerun_diff`` of ``full``
    (the distance between two uninterrupted runs: 0.0 where they are bit for
    bit). Prints the phase line."""
    import numpy as np

    with _SaveTimer() as t:
        try:
            call(checkpoint=ckpt, checkpoint_every=every, **kill)
        except _Kill:
            pass
        else:
            raise AssertionError(f"30{label}: the kill did not fire")
    with np.load(ckpt) as d:
        resumed_from = int(d["frame"])
    size = ckpt.stat().st_size
    n_left = launches_left(resumed_from)
    also = also_left(resumed_from)
    res, wall = _counted(path_kernel, n_left, lambda: call(checkpoint=ckpt, checkpoint_every=every),
                         also=also)
    diff = _max_diff(res, full)
    if diff > rerun_diff:
        raise AssertionError(f"30{label}: the resumed run is {diff} from the uninterrupted one "
                             f"(two uninterrupted runs: {rerun_diff})")
    save_ms = statistics.mean(ms for _, ms in t.saves)
    _line(f"30{label} resume", ok=True, **kv, every=every,
          saved_at=",".join(str(d) for d, _ in t.saves), resumed_from=resumed_from,
          launches=",".join(f"{k.__name__}:{n}" for k, n in ((path_kernel, n_left),) + also),
          max_abs_diff=diff, rerun_max_abs_diff=rerun_diff, state_bytes=size, save_ms=f"{save_ms:.3f}",
          resumed_wall_s=f"{wall:.3f}", card=repr(card))


_CHILD = """
import sys, time, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from vae_equalizer_tpu_torch.train import train_vae_dp
from vae_equalizer_tpu_torch.utils import DpConfig
def slow(frame, m):  # every frame: the parent's SIGKILL lands between two frames
    time.sleep(0.3)
train_vae_dp(DpConfig(num_frames={frames}), seed=0, device="cuda", use_pallas="frame", runs={runs},
             checkpoint=sys.argv[1], checkpoint_every={every}, progress=slow)
"""


def _resume_phases(card: str) -> None:
    """Phase 30: kill and resume four kernel paths on the card. Each
    uninterrupted run (default draws, a CUDA generator) is run, then the same
    call with a checkpoint, killed after a save, then resumed; the two
    results must agree bit for bit (every history and the final parameters
    or taps), and the resumed call launches only the remaining frames'
    kernels. (a) the flagship frame mode, killed from ``progress``; (b) the
    same call killed by SIGKILL in a child process, resumed here; (c) CMA
    through kernel C; (d) the AWGN VAE-LE through kernel F; (e) the AWGN CMA
    through kernel I in segments, held against one whole launch."""
    import os
    import pathlib
    import shutil
    import signal
    import tempfile

    import numpy as np

    from vae_equalizer_tpu_torch.ops.cma_kernel import cma_dp_kernel
    from vae_equalizer_tpu_torch.ops.cma_siso_kernel import cma_siso_experiment
    from vae_equalizer_tpu_torch.ops.elbo_siso_kernel import vae_siso_loss_and_grad
    from vae_equalizer_tpu_torch.ops.frame_kernel import vae_dp_frame_train
    from vae_equalizer_tpu_torch.train import awgn as train_awgn
    from vae_equalizer_tpu_torch.train import dp as train_dp
    from vae_equalizer_tpu_torch.utils import AwgnCmaConfig, AwgnVaeLeConfig, DpConfig

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_resume_"))
    t_phase = time.perf_counter()
    try:
        # ---- 30a. the flagship, 12 frames of 10,000 symbols, R = 8, K = 5
        frames, runs, every = 12, 8, 5
        cfg = DpConfig(num_frames=frames)

        def flagship(**kw):
            return train_dp.train_vae_dp(cfg, seed=0, device=DEVICE, use_pallas="frame", runs=runs,
                                         **kw)

        full, _ = _counted(vae_dp_frame_train, frames, flagship, also=_with_eval(frames))
        rerun = _max_diff(flagship(), full)
        _resume_case("a", card, flagship, full, rerun, tmp / "a.npz", every,
                     {"progress": _killer(8)}, vae_dp_frame_train, lambda f: frames - f,
                     lambda f: _with_eval(frames - f), frames=frames, runs=runs)

        # ---- 30b. the same call, SIGKILLed in a child process after its first save
        ckpt = tmp / "b.npz"
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.dirname(os.path.abspath(__file__)), os.environ.get("PYTHONPATH", "")]))
        child = subprocess.Popen(
            [sys.executable, "-c", _CHILD.format(frames=frames, runs=runs, every=every), str(ckpt)],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        try:
            t0 = time.time()
            while not ckpt.exists():
                if child.poll() is not None:
                    raise AssertionError(f"30b: the child ended ({child.returncode}) before its "
                                         f"first save: {child.stderr.read()[-2000:]}")
                if time.time() - t0 > 300:
                    raise AssertionError("30b: no state file after 300 s")
                time.sleep(0.01)
            os.kill(child.pid, signal.SIGKILL)
        finally:
            if child.poll() is None:
                child.kill()
            child.communicate(timeout=60)
        rc = child.returncode
        if rc != -signal.SIGKILL:
            raise AssertionError(f"30b: the child exited with {rc}, not by SIGKILL")
        tmp_left = ckpt.with_name(ckpt.name + ".tmp").exists()
        with np.load(ckpt) as d:
            resumed_from = int(d["frame"])
        res, wall = _counted(vae_dp_frame_train, frames - resumed_from,
                             lambda: flagship(checkpoint=ckpt, checkpoint_every=every),
                             also=_with_eval(frames - resumed_from))
        diff = _max_diff(res, full)
        if diff > rerun:
            raise AssertionError(f"30b: the resumed run is {diff} from the uninterrupted one")
        _line("30b resume SIGKILL", ok=True, frames=frames, runs=runs, every=every,
              child_rc=rc, resumed_from=resumed_from, tmp_left=tmp_left,
              launches=f"vae_dp_frame_train:{frames - resumed_from},"
              f"vae_dp_frame_eval:{frames - resumed_from}", max_abs_diff=diff,
              state_bytes=ckpt.stat().st_size, resumed_wall_s=f"{wall:.3f}", card=repr(card))

        # ---- 30c. CMA through kernel C, R = 5, 12 frames, K = 5
        cfg_c = dataclasses.replace(cfg, loss_type="CMA", lr=CMA_VARIANTS["CMA"][1])

        def cma(**kw):
            return train_dp.run_cma_dp(cfg_c, seed=0, device=DEVICE, runs=CMA_RUNS, use_pallas=True,
                                       **kw)

        full, _ = _counted(cma_dp_kernel, frames, cma, also=_with_channel(frames))
        _resume_case("c", card, cma, full, _max_diff(cma(), full), tmp / "c.npz", every,
                     {"progress": _killer(8)}, cma_dp_kernel, lambda f: frames - f,
                     lambda f: _with_channel(frames - f), frames=frames, runs=CMA_RUNS)

        # ---- 30d. the AWGN VAE-LE through kernel F, R = 20, 20 epochs, K = 6
        cfg_d = AwgnVaeLeConfig(num_epochs=20)
        steps = cfg_d.n_train // cfg_d.batch_len

        def vaele(**kw):
            return train_awgn.train_vae_le_awgn(cfg_d, seed=0, device=DEVICE, runs=AWGN_RUNS,
                                                use_pallas=True, **kw)

        full, _ = _counted(vae_siso_loss_and_grad, cfg_d.num_epochs * steps, vaele)
        _resume_case("d", card, vaele, full, _max_diff(vaele(), full), tmp / "d.npz", 6,
                     {"progress": _killer(14)}, vae_siso_loss_and_grad,
                     lambda e: (cfg_d.num_epochs - e) * steps, epochs=cfg_d.num_epochs,
                     runs=AWGN_RUNS)

        # ---- 30e. the AWGN CMA through kernel I in segments, R = 8, 40 epochs, K = 10
        cfg_e = AwgnCmaConfig(num_epochs=40)

        def cma_awgn(**kw):
            return train_awgn.run_cma_awgn(cfg_e, seed=0, device=DEVICE, runs=CMA_AWGN_RUNS, **kw)

        whole, _ = _counted(cma_siso_experiment, 1, cma_awgn)
        segmented, _ = _counted(cma_siso_experiment, 4, lambda: cma_awgn(
            checkpoint=tmp / "e_segmented.npz", checkpoint_every=10))
        seg_diff = _max_diff(segmented, whole)
        if seg_diff != 0.0:
            raise AssertionError(f"30e: 4 segments of kernel I are {seg_diff} from one launch")
        real, calls = train_awgn.cma_siso_experiment, []

        def dies_in_segment_3(*a):
            calls.append(1)
            if len(calls) == 3:
                raise _Kill("killed in segment 3")
            return real(*a)

        # the kill: the killed run's 3rd launch raises; the resumed run's
        # launches (the 4th and 5th calls) go through
        train_awgn.cma_siso_experiment = dies_in_segment_3
        try:
            _resume_case("e", card, cma_awgn, whole, 0.0, tmp / "e.npz", 10, {}, cma_siso_experiment,
                         lambda e: -(-(cfg_e.num_epochs - e) // 10), epochs=cfg_e.num_epochs,
                         runs=CMA_AWGN_RUNS, segments_vs_whole_max_abs_diff=seg_diff)
        finally:
            train_awgn.cma_siso_experiment = real
        _line("30 resume", ok=True, wall_s=f"{time.perf_counter() - t_phase:.1f}", card=repr(card))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


GRAPH_DEPTH = 12  # frames (epochs) of phase 31 (b)'s runs
GRAPH_CHUNK = 16  # phase 31 (a)'s chunk_frames: not a divisor of 170
GRAPH_TIMED_EPOCHS = 100  # phase 31 (c)'s G and H experiments (50 evals)


def _device_time(fn) -> tuple:
    """(the kernels' summed device seconds over ``fn()``, from torch.profiler
    (CUPTI; nan where it shows none), the wall seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = 0.0
    for ev in prof.key_averages():
        dev_us += getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0.0)
    return (dev_us * 1e-6 if dev_us > 0 else float("nan")), wall


def _graph_phases(card: str) -> None:
    """Phase 31: the loops as CUDA-graph replay (``train/harness.py``). Each
    graph-mode run is held to its loop-mode run on the same seed, bit for bit
    (``_max_diff`` 0.0 over every history and the final params or taps).
    Launch counts: a capture records its kernels' launches, and each replay
    adds them to the wrappers' counts (captured launches x replays), so
    ``_counted`` reads a compiled run's launches as a loop's; the warm-up's
    launches are not counted. ``timings`` runs the whole experiment 3 times
    (3 x the launches)."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from vae_equalizer_tpu_torch.drivers import eval_run_dp
    from vae_equalizer_tpu_torch.ops.cma_frame_kernel import cma_chunked_frame
    from vae_equalizer_tpu_torch.ops.cma_kernel import cma_dp_kernel
    from vae_equalizer_tpu_torch.ops.cma_siso_kernel import cma_siso_experiment
    from vae_equalizer_tpu_torch.ops.elbo_kernel import vae_dp_loss_and_grad
    from vae_equalizer_tpu_torch.ops.elbo_siso_kernel import vae_siso_loss_and_grad
    from vae_equalizer_tpu_torch.ops.frame_kernel import vae_dp_frame_train
    from vae_equalizer_tpu_torch.ops.nn_frame_kernel import vae_nn_experiment_train
    from vae_equalizer_tpu_torch.ops.siso_frame_kernel import vae_siso_experiment_train
    from vae_equalizer_tpu_torch.train import awgn as train_awgn
    from vae_equalizer_tpu_torch.train import dp as train_dp
    from vae_equalizer_tpu_torch.utils import (
        AwgnCmaConfig,
        AwgnVaeLeConfig,
        AwgnVaeNnConfig,
        DpConfig,
    )

    def same(label, got, want):
        diff = {k: _max_diff(got[k], want[k]) for k in want}
        if any(d != 0.0 for d in diff.values()):
            raise AssertionError(f"31{label}: graph replay differs from the loop mode: {diff}")
        return diff

    # (a) the flagship at full width, 170 frames, R = 8: loop, compiled,
    # loop, compiled (walls in turns), then compiled with timings and
    # chunk_frames = 16
    cfg, R = DpConfig(), 8
    n_sym = cfg.n_frame_max // cfg.batch_len * cfg.batch_len
    F = cfg.num_frames
    flag = lambda **kw: train_dp.train_vae_dp(cfg, seed=0, device=DEVICE, use_pallas="frame",  # noqa: E731
                                              runs=R, **kw)
    walls = {"loop": [], "compiled": []}
    res = {}
    for mode in ("loop", "compiled", "loop", "compiled"):
        res[mode], wall = _counted(vae_dp_frame_train, F, lambda mode=mode: flag(
            compiled=mode == "compiled"), also=_with_eval(F))
        walls[mode].append(wall)
    ref = res["loop"]
    timings = {}
    timed, wall_t = _counted(vae_dp_frame_train, 3 * F, lambda: flag(compiled=True, timings=timings),
                             also=_with_eval(3 * F))
    chunked, wall_k = _counted(vae_dp_frame_train, F, lambda: flag(chunk_frames=GRAPH_CHUNK),
                               also=_with_eval(F))
    diffs = {}
    for label, got in (("compiled", res["compiled"]), ("timed", timed), ("chunked", chunked)):
        d = same("a", got, ref)
        diffs[label] = ",".join(f"{k}:{d[k]}" for k in ("ser", "mi", "var_est", "params"))
    soft = float(ref["ser"][:, 2:, -20:].mean())
    if not SER_BAND[0] <= soft <= SER_BAND[1]:
        raise AssertionError(f"31a: last-20-frame soft SER {soft:.5f} outside {SER_BAND}")
    if set(timings) != {"compile_s", "run_s"} or not min(timings.values()) > 0:
        raise AssertionError(f"31a: timings {timings}")
    # the device's busy share over 20 frames (torch.profiler): the loop's
    # kernel time over its wall; under replay, a compiled run with timings
    # (the warm-up's frame and 3 replays of the 20) is profiled, and its
    # kernel time per frame is set against run_s per frame
    f20 = 20
    cfg20 = dataclasses.replace(cfg, num_frames=f20)
    run20 = lambda **kw: train_dp.train_vae_dp(  # noqa: E731
        cfg20, seed=0, device=DEVICE, use_pallas="frame", runs=R, **kw)
    dev_loop, wall_loop20 = _device_time(run20)
    busy_loop = dev_loop / wall_loop20
    t20 = {}
    dev_graph, _ = _device_time(lambda: run20(compiled=True, timings=t20))
    dev_frame_graph = dev_graph / (3 * f20 + 1)
    busy_graph = dev_frame_graph * f20 / t20["run_s"]
    _line("31a graphs flagship", ok=True, runs=R, frames=F, kernel_b_launches=F,
          max_abs_diff=repr(diffs), soft_ser_last20=f"{soft:.5f}",
          wall_s_turns="loop:{:.3f},compiled:{:.3f},loop:{:.3f},compiled:{:.3f}".format(
              walls["loop"][0], walls["compiled"][0], walls["loop"][1], walls["compiled"][1]),
          frame_ms_loop=f"{1e3 * min(walls['loop']) / F:.3f}",
          frame_ms_compiled=f"{1e3 * min(walls['compiled']) / F:.3f}",
          compile_s=f"{timings['compile_s']:.3f}", run_s=f"{timings['run_s']:.3f}",
          timed_wall_s=f"{wall_t:.3f}", chunk_frames=GRAPH_CHUNK, chunked_wall_s=f"{wall_k:.3f}",
          busy_share_loop=f"{busy_loop:.3f}", busy_share_replay=f"{busy_graph:.3f}",
          device_ms_per_frame=f"loop:{1e3 * dev_loop / f20:.3f},replay:{1e3 * dev_frame_graph:.3f}",
          replay_ms_per_frame=f"{1e3 * timings['run_s'] / F:.3f}",
          sym_per_s_compiled=f"{R * F * n_sym / min(walls['compiled']):.0f}", card=repr(card))

    # (b) the other modes at the same widths, depth cut to GRAPH_DEPTH
    # frames (epochs; the AWGN VAE-LE True at its full 500): compiled with
    # timings against the loop, bit for bit; per frame (epoch) the loop's
    # wall and the replay's run_s
    D = GRAPH_DEPTH
    cfg_d = dataclasses.replace(cfg, num_frames=D)
    # (label, kernel, its launches, the DP channel's frames, the call)
    cases = [
        ("VAE True (A)", vae_dp_loss_and_grad, D * (n_sym // cfg.batch_len), D,
         lambda kw: train_dp.train_vae_dp(cfg_d, seed=0, device=DEVICE, use_pallas=True, runs=R,
                                          **kw)),
        ("VAEflex frame (B)", vae_dp_frame_train, D, D,
         lambda kw: train_dp.train_vae_flex_dp(cfg_d, seed=0, device=DEVICE, use_pallas="frame",
                                               runs=R, **kw)),
    ]
    for v, (mode, lr_v, _) in CMA_VARIANTS.items():
        cfg_v = dataclasses.replace(cfg_d, loss_type=v, lr=lr_v)
        cases.append((f"{v} ({'C' if v == 'CMA' else 'D'})",
                      cma_dp_kernel if v == "CMA" else cma_chunked_frame, D, D,
                      lambda kw, cfg_v=cfg_v, mode=mode: train_dp.run_cma_dp(
                          cfg_v, seed=0, device=DEVICE, runs=CMA_RUNS, use_pallas=mode, **kw)))
    cfg_le = AwgnVaeLeConfig()
    steps_le = cfg_le.num_epochs * (cfg_le.n_train // cfg_le.batch_len)
    cases.append(("AWGN VAE-LE True (F)", vae_siso_loss_and_grad, steps_le, 0,
                  lambda kw: train_awgn.train_vae_le_awgn(cfg_le, seed=0, device=DEVICE,
                                                          runs=AWGN_RUNS, use_pallas=True, **kw)))
    cfg_nn = dataclasses.replace(AwgnVaeNnConfig(), num_epochs=D)
    cases.append(("AWGN VAE-NN loop (Net)", None, 0, 0,
                  lambda kw: train_awgn.train_vae_nn_awgn(cfg_nn, seed=0, device=DEVICE,
                                                          runs=NN_RUNS, **kw)))
    cfg_i = dataclasses.replace(AwgnCmaConfig(), num_epochs=10 * D)
    cases.append(("AWGN CMA (I)", cma_siso_experiment, 1, 0,
                  lambda kw: train_awgn.run_cma_awgn(cfg_i, seed=0, device=DEVICE,
                                                     runs=CMA_AWGN_RUNS, **kw)))
    for label, kern, n, ch, fn in cases:
        t = {}
        graph_fn = lambda fn=fn, t=t: fn({"compiled": True, "timings": t})  # noqa: E731
        if kern is None:  # the plain engine: no kernel of the table is launched
            loop, wall_l = _counted(vae_dp_frame_train, 0, lambda fn=fn: fn({}))
            graph, wall_g = _counted(vae_dp_frame_train, 0, graph_fn)
        else:
            # kernel B's frame path evaluates each frame with kernel K; every
            # DP path runs the channel (kernel L) once a frame
            also = _with_eval if kern is vae_dp_frame_train else _with_channel
            loop, wall_l = _counted(kern, n, lambda fn=fn: fn({}), also=also(ch))
            graph, wall_g = _counted(kern, 3 * n, graph_fn, also=also(3 * ch))
        diff = same("b", graph, loop)
        for k in ("ser", "mi"):
            if not np.all(np.isfinite(np.asarray(loop[k]))):
                raise AssertionError(f"31b {label}: non-finite {k}")
        depth = cfg_le.num_epochs if "VAE-LE" in label else (10 * D if "(I)" in label else D)
        _line("31b graphs", ok=True, path=repr(label), depth=depth,
              launches=f"{kern.__name__}:{n}" if kern else "none",
              max_abs_diff=max(diff.values()), loop_wall_s=f"{wall_l:.3f}",
              compile_s=f"{t['compile_s']:.3f}", run_s=f"{t['run_s']:.3f}",
              ms_per_step=f"loop:{1e3 * wall_l / depth:.3f},replay:{1e3 * t['run_s'] / depth:.3f}",
              card=repr(card))

    # (c) timings on the one-program G and H experiments: the keys, run_s at
    # most the plain run's wall, the timed result equal to the plain run
    De = GRAPH_TIMED_EPOCHS
    for label, kern, fn in (
            ("G", vae_siso_experiment_train, lambda **kw: train_awgn.train_vae_le_awgn(
                dataclasses.replace(AwgnVaeLeConfig(), num_epochs=De), seed=0, device=DEVICE,
                runs=AWGN_RUNS, use_pallas="frame", **kw)),
            ("H", vae_nn_experiment_train, lambda **kw: train_awgn.train_vae_nn_awgn(
                dataclasses.replace(AwgnVaeNnConfig(), num_epochs=De), seed=0, device=DEVICE,
                runs=NN_RUNS, use_pallas="frame", **kw))):
        plain, wall_p = _counted(kern, 1, fn)
        t = {}
        timed, wall_t = _counted(kern, 3, lambda fn=fn, t=t: fn(timings=t))
        same("c", timed, plain)
        if set(t) != {"compile_s", "run_s"} or not t["run_s"] <= wall_p:
            raise AssertionError(f"31c {label}: timings {t}, the plain run's wall {wall_p:.3f} s")
        _line("31c graphs timings", ok=True, kernel=label, epochs=De, compile_s=f"{t['compile_s']:.3f}",
              run_s=f"{t['run_s']:.3f}", plain_wall_s=f"{wall_p:.3f}", max_abs_diff=0.0,
              card=repr(card))

    # (d) the Eval_run_DP driver, --quick on the card: --compiled and
    # --frames-per-call 4 give every point's SER of the run without them
    tmp = tempfile.mkdtemp(prefix="chip_smoke_graphs_")
    try:
        sers = {}
        for name, extra in (("loop", []), ("compiled", ["--compiled"]),
                            ("chunked", ["--frames-per-call", "4"])):
            out = os.path.join(tmp, name)
            eval_run_dp.main(["--quick", "--pallas-frame", "--device", DEVICE, "--out", out, *extra])
            (jsonl,) = [f for f in os.listdir(out) if f.endswith(".jsonl")]
            with open(os.path.join(out, jsonl)) as f:
                sers[name] = [json.loads(ln)["ser"] for ln in f if ln.strip()]
        if not sers["compiled"] == sers["chunked"] == sers["loop"]:
            raise AssertionError("31d: eval_run_dp --compiled / --frames-per-call 4 SER differs "
                                 "from the run without the flag")
        _line("31d graphs driver", ok=True, points=len(sers["loop"]), max_abs_diff=0.0,
              card=repr(card))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


SP_FRAMES = 6  # phase 32b's frames of DpConfig() (10,000 symbols), R = 2
# 32b holds the sharded runners' SER, frame by frame, to the unsharded
# runners': within SP_SER_TOL, or, where the unsharded runner's own rounding
# parts further, within SP_CHAOS times the distance at which it parts from
# itself with w moved by 1e-7 (phase 16b's cold-start rule). A frame is 100
# dependent Adam steps of VAE and 990 of VAEflex from zero moments, and past
# ~150 two float32 roundings part: on the card the unsharded VAE parts from
# itself so moved by 0.00134 / 0.00379 on frames 0 / 1, VAEflex by 0.034 /
# 0.381 (tools/first_check_seqpar.py's run and phase 32's first run, PR 15)
SP_SER_TOL = 2e-3
SP_CHAOS = 4.0
SP_STEP_TOL = {"loss": 2e-5, "var_est": 2e-5, "grad": 1e-4}  # 32a, relative (grad: to max |g|)


def _seqpar_phases(card: str) -> None:
    """Phase 32: sequence parallelism (``parallel/seqpar.py``), every rank a
    gloo rank on the one card, at the flagship's width (DpConfig(): 64-QAM,
    sps 2, M 25, 23 dB, minibatch 100). The sharded step is autograd plus
    collectives, as in JAX: it launches none of the kernels A-J (counted on
    rank 0, this process). Two ranks on one card measure correctness, not the
    speed of sp: their collectives go through the host under gloo."""
    import dataclasses as dc

    import numpy as np
    import torch

    from vae_equalizer_tpu_torch.models import (
        butterfly_init,
        dirac_taps_dp,
        elbo_dp,
        vae_le_dp_forward,
    )
    from vae_equalizer_tpu_torch.ops.elbo_kernel import vae_dp_loss_and_grad
    from vae_equalizer_tpu_torch.ops.frame_kernel import adam_update
    from vae_equalizer_tpu_torch.parallel.dryrun import dryrun_multichip
    from vae_equalizer_tpu_torch.parallel.mesh import make_mesh_2d, run_ranks
    from vae_equalizer_tpu_torch.parallel.seqpar import make_sp_dp_train_step, sharded_call
    from vae_equalizer_tpu_torch.train import dp as train_dp
    from vae_equalizer_tpu_torch.utils import DpConfig

    dev = torch.device(f"{DEVICE}:0")
    on_card = lambda w: make_mesh_2d(w // 2, 2, devices=[str(dev)] * w)  # noqa: E731
    cfg, R = DpConfig(), 2
    n_sym = cfg.n_frame_max // cfg.batch_len * cfg.batch_len
    const, var, sim, amps, P = train_dp._setup(cfg, n_sym, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(32)
    rx_frame = sim.physics(torch.tensor(cfg.theta, device=dev), *sim.draws(g, R))[0]
    mb = rx_frame[..., : cfg.batch_len * cfg.sps].contiguous()  # the frame's first minibatch

    def unsharded_step(params, opt):
        w, h = (params[k].to(dev).requires_grad_() for k in ("w", "h"))
        q, _ = vae_le_dp_forward(w, mb, amps, var, const.nu_sc, cfg.sps)
        loss, var_est = elbo_dp(q, mb, h, amps, P)
        gw, gh = torch.autograd.grad(loss.sum(), (w, h))
        moments = {k: v.to(dev) for k, v in opt.items()}
        new_p, _ = adam_update({"w": w.detach(), "h": h.detach()}, moments, {"w": gw, "h": gh},
                               cfg.lr, 0)
        return loss.detach(), var_est, {"w": gw, "h": gh}, new_p

    def check_step(label, st, params, opt):
        loss, var_est, grads, new_p = unsharded_step(params, opt)
        rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
        err = {"loss": rel(st["loss"], loss), "var_est": rel(st["var_est"], var_est),
               "gw": rel(st["grads"]["w"], grads["w"]), "gh": rel(st["grads"]["h"], grads["h"])}
        ratio = {k: float((st["grads"][k] * grads[k]).sum() / (grads[k] * grads[k]).sum())
                 for k in ("w", "h")}
        p_err = {k: float((st["params"][k] - new_p[k]).abs().max()) for k in ("w", "h")}
        bad = [k for k, e in err.items() if e > SP_STEP_TOL["grad" if k[0] == "g" else k]]
        if bad or any(abs(r - 1) > SP_STEP_TOL["grad"] for r in ratio.values()) or max(
                p_err.values()) > 2e-6 + 1e-4 * max(float(v.abs().max()) for v in new_p.values()):
            raise AssertionError(f"32a {label}: sharded step vs unsharded {err}, grad ratio "
                                 f"{ratio}, params after Adam {p_err}")
        _line(f"32a seqpar step {label}", ok=True, runs=R, samples=mb.shape[-1],
              rel_err=",".join(f"{k}:{v:.2e}" for k, v in err.items()), tol=SP_STEP_TOL,
              grad_ratio=",".join(f"{k}:{v:.7f}" for k, v in ratio.items()),
              adam_abs_err=",".join(f"{k}:{v:.2e}" for k, v in p_err.items()), card=repr(card))
        return max(err["gw"], err["gh"])

    # (a) dp 2 x sp 2 (four ranks on the card) alone; dp 1 x sp 2 rides (b)'s ranks
    step4 = make_sp_dp_train_step(on_card(4), mod=cfg.mod, snr_db=cfg.snr_db, m_est=cfg.m_est,
                                  sps=cfg.sps, lr=cfg.lr)
    params, opt = step4.init(R)
    st4, wall4 = _counted(vae_dp_loss_and_grad, 0, lambda: step4(params, opt, mb))
    grad_err = check_step("dp2xsp2", st4, params, opt)

    # (b) the sharded runners, dp 1 x sp 2, against the unsharded autograd runners
    mesh = on_card(2)
    step2 = dc.replace(step4, mesh=mesh)
    cfg_b = dc.replace(cfg, num_frames=SP_FRAMES)
    stats = {"VAE": {}, "VAEflex": {}}
    calls = [step2.call(params, opt, mb)] + [
        sharded_call(cfg_b, 0, device=DEVICE, runs=R, mesh=mesh, flex_windows=name == "VAEflex",
                     stats=stats[name])[1] for name in stats]
    # rank 0, this process, draws and runs each frame's channel (kernel L)
    (st2, vae, flex), wall_sp = _counted(vae_dp_loss_and_grad, 0, lambda: run_ranks(mesh, calls),
                                         also=_with_channel(2 * SP_FRAMES))
    grad_err = max(grad_err, check_step("dp1xsp2", st2, params, opt))
    g.manual_seed(33)
    w_moved = {"w": butterfly_init(cfg.m_est, dev) + 1e-7 * torch.randn(
        (2, 4, cfg.m_est), generator=g, device=dev), "h": dirac_taps_dp(cfg.m_est, dev)}
    for name, got, runner in (("VAE", vae, train_dp.train_vae_dp),
                              ("VAEflex", flex, train_dp.train_vae_flex_dp)):
        ref, wall = _counted(vae_dp_loss_and_grad, 0, lambda runner=runner: runner(
            cfg_b, 0, device=DEVICE, runs=R), also=_with_channel(SP_FRAMES))
        moved = runner(cfg_b, 0, device=DEVICE, runs=R, params_init=w_moved)
        d = np.abs(got["ser"] - ref["ser"]).max(axis=(0, 1))  # per frame
        d_self = np.abs(moved["ser"] - ref["ser"]).max(axis=(0, 1))
        tol = np.maximum(SP_SER_TOL, SP_CHAOS * d_self)
        if got["ser"].shape != (R, 4, SP_FRAMES) or not (
                np.all(np.isfinite(got["ser"])) and np.all(np.isfinite(got["mi"]))):
            raise AssertionError(f"32b {name}: SER {got['ser'].shape}, not all finite")
        if np.any(d > tol):
            raise AssertionError(f"32b {name}: sharded SER vs unsharded per frame {d.tolist()} "
                                 f"beyond {tol.tolist()} (unsharded vs itself with w moved by "
                                 f"1e-7: {d_self.tolist()})")
        st = stats[name]
        _line(f"32b seqpar {name}", ok=True, mesh="dp1xsp2", runs=R, frames=SP_FRAMES,
              max_dser_per_frame=",".join(f"{v:.5f}" for v in d),
              unsharded_moved_dser=",".join(f"{v:.5f}" for v in d_self),
              tol=",".join(f"{v:.5f}" for v in tol),
              soft_ser_last=f"{float(got['ser'][:, 2:, -1].mean()):.5f}",
              sharded_train_ms_per_frame=f"{1e3 * st['train_s'] / st['frames']:.1f}",
              collective_share=f"{st['collective_s'] / st['train_s']:.3f}",
              unsharded_ms_per_frame=f"{1e3 * wall / SP_FRAMES:.1f}", launches=0, card=repr(card))
    _line("32b seqpar call", ok=True, ranks=2, calls=3, wall_s=f"{wall_sp:.2f}",
          dp2xsp2_step_wall_s=f"{wall4:.2f}", card=repr(card))

    # (c) the dryrun's self-certification on the card
    # the dryrun's 2 frames sharded (rank 0's channel) and unsharded
    res, wall_c = _counted(vae_dp_loss_and_grad, 0, lambda: dryrun_multichip(
        2, device=DEVICE, devices=[str(dev)] * 2), also=_with_channel(4))
    _line("32c seqpar dryrun", ok=True, mesh=f"dp{res['n_dp']}xsp{res['n_sp']}",
          d_ser=f"{res['d_ser']:.5f}", tol=f"{res['tol']:.5f}", wall_s=f"{wall_c:.2f}",
          max_grad_rel_err=f"{grad_err:.2e}", card=repr(card))
    return vae


SP_EVERY = 2  # phase 33b's checkpoint_every
SP_KILL_FRAME = 2  # 33b's child is killed in this frame's progress (3 frames done; saved at 2)
_SP_CHILD = """
import json, sys, time, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from vae_equalizer_tpu_torch.parallel.mesh import make_mesh_2d, run_ranks
from vae_equalizer_tpu_torch.parallel.seqpar import sharded_call
from vae_equalizer_tpu_torch.utils import DpConfig
stats = {{}}
def hold(frame, m):  # report each frame; wait to be killed after frame {kill}
    print(frame, json.dumps(stats["saves"]), flush=True)
    if frame == {kill}:
        time.sleep(600)
mesh = make_mesh_2d(1, 2, devices=["{device}"] * 2)
cfg = DpConfig(num_frames={frames}, n_frame_max={n_frame_max})
run_ranks(mesh, [sharded_call(cfg, 0, device="{device}", runs={runs},
                              mesh=mesh, checkpoint=sys.argv[1], checkpoint_every={every},
                              progress=hold, stats=stats)[1]])
"""


def _live_in_group(pgid: int) -> int:
    """Processes of the process group ``pgid`` that are alive (not zombies)."""
    import pathlib

    n = 0
    for stat in pathlib.Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        n += int(fields[2]) == pgid and fields[0] != "Z"
    return n


def _sp_kill_child(ckpt, errfile, cfg, runs: int, device: str) -> tuple:
    """33b: the sharded VAE run with a checkpoint in a child process, SIGKILLed
    with its whole process group (rank 0 and its spawned rank) in frame
    SP_KILL_FRAME's progress. Returns (the child's return code, the saves it
    reported: (frame, gather s, write s), the group's processes alive after
    the kill)."""
    import os
    import pathlib
    import signal
    import threading

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__)), os.environ.get("PYTHONPATH", "")]))
    code = _SP_CHILD.format(frames=cfg.num_frames, n_frame_max=cfg.n_frame_max, runs=runs,
                            device=device, every=SP_EVERY, kill=SP_KILL_FRAME)
    with open(errfile, "w") as err:
        child = subprocess.Popen([sys.executable, "-c", code, str(ckpt)], env=env,
                                 stdout=subprocess.PIPE, stderr=err, text=True,
                                 start_new_session=True)

    def kill():
        try:
            os.killpg(child.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass

    deadline = threading.Timer(300, kill)  # a child that never reports is killed too
    deadline.start()
    saves, killed = [], False
    try:
        for line in child.stdout:
            frame, reported = line.split(" ", 1)
            saves = json.loads(reported)
            if int(frame) == SP_KILL_FRAME:
                kill()
                killed = True
                break
    finally:
        deadline.cancel()
        kill()
        child.communicate(timeout=60)
    t0 = time.time()
    while _live_in_group(child.pid) and time.time() - t0 < 10:
        time.sleep(0.1)
    alive = _live_in_group(child.pid)
    if not killed:
        raise AssertionError(f"33b: the child ended ({child.returncode}) before frame "
                             f"{SP_KILL_FRAME}: {pathlib.Path(errfile).read_text()[-2000:]}")
    return child.returncode, saves, alive


def _profiling_phase(card: str, f_args: tuple, ms_b: float) -> None:
    """Phase 33c: ``utils/profiling.py``'s timed and trace on kernel B (phase
    4b's arguments ``f_args`` and time ``ms_b``). It runs before phase 32:
    on the card (torch 2.11), after phase 31's profiler sessions and then
    phases 32-33b's process groups, two full runs' traces held 0 CUDA
    kernel events; traced after profiler sessions and CUDA graphs but before
    any process group, every kernel is named."""
    import pathlib
    import shutil
    import tempfile

    from vae_equalizer_tpu_torch.ops.frame_kernel import vae_dp_frame_train
    from vae_equalizer_tpu_torch.utils import DpConfig
    from vae_equalizer_tpu_torch.utils.profiling import timed, trace

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_trace_"))
    try:
        bl = DpConfig().batch_len
        run_b = lambda: vae_dp_frame_train(*f_args, bl_sym=bl)  # noqa: E731
        med_s, out = timed(run_b, warmup=1, reps=5)
        if not (0.5 * ms_b <= 1e3 * med_s <= 2.0 * ms_b) or out[0].shape != f_args[0].shape:
            raise AssertionError(f"33c: timed median {1e3 * med_s:.3f} ms, phase 4b {ms_b:.3f} ms")
        reps = 3
        with trace(tmp / "trace") as prof:
            for _ in range(reps):
                run_b()
        (path,) = (tmp / "trace").glob("trace_*.json")
        kernels = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
                   if e.get("cat") == "kernel"]
        n_b = sum("vae_dp_frame_kernel" in k for k in kernels)
        dev_ms = sum(getattr(e, "device_time_total", 0.0) for e in prof.key_averages()
                     if "vae_dp_frame_kernel" in e.key) / 1e3
        if not n_b:
            raise AssertionError(f"33c: the trace {path.name} does not name vae_dp_frame_kernel; "
                                 f"its {len(kernels)} kernel events: {sorted(set(kernels))[:12]}")
        _line("33c profiling kernel B", ok=True, runs=f_args[0].shape[0],
              timed_median_ms=f"{1e3 * med_s:.3f}", phase_4b_ms=f"{ms_b:.3f}",
              trace_bytes=path.stat().st_size, trace_kernel_events=len(kernels),
              trace_kernel_b_events=f"{n_b}/{reps}",
              profiler_device_ms_per_launch=f"{dev_ms / reps:.3f}", card=repr(card))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _seqpar_option_phases(card: str, vae_loop: dict) -> None:
    """Phase 33a-b: the sharded runners' compiled, chunk_frames and
    checkpoint (``parallel/seqpar.py``; every rank calls the step eagerly,
    gloo's collectives pass through the host) at phase 32b's shapes, held to
    32b's sharded loop result ``vae_loop``."""
    import pathlib
    import shutil
    import signal
    import tempfile

    import numpy as np
    import torch

    from vae_equalizer_tpu_torch.ops.elbo_kernel import vae_dp_loss_and_grad
    from vae_equalizer_tpu_torch.parallel.mesh import make_mesh_2d, run_ranks
    from vae_equalizer_tpu_torch.parallel.seqpar import sharded_call
    from vae_equalizer_tpu_torch.utils import DpConfig

    dev = torch.device(f"{DEVICE}:0")
    mesh = make_mesh_2d(1, 2, devices=[str(dev)] * 2)
    cfg, R = DpConfig(num_frames=SP_FRAMES), 2
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_sp_"))
    t_phase = time.perf_counter()
    try:
        # (b) the kill first: its file feeds the resume, which rides (a)'s ranks
        ckpt = tmp / "sp.npz"
        rc, child_saves, alive = _sp_kill_child(ckpt, tmp / "child.err", cfg, R, str(dev))
        if rc != -signal.SIGKILL or alive:
            raise AssertionError(f"33b: the child exited with {rc}, not by SIGKILL, or {alive} "
                                 "process(es) of its group outlived the kill")
        with np.load(ckpt) as d:
            resumed_from, w_shape = int(d["frame"]), d["leaf_0001"].shape
        size = ckpt.stat().st_size
        stats = {}
        calls = [sharded_call(cfg, 0, device=DEVICE, runs=R, mesh=mesh, **kw)[1] for kw in (
            {"compiled": True}, {"chunk_frames": 2},
            {"checkpoint": ckpt, "checkpoint_every": SP_EVERY, "stats": stats})]
        (comp, chunk, resumed), wall = _counted(
            vae_dp_loss_and_grad, 0, lambda: run_ranks(mesh, calls),
            also=_with_channel(3 * SP_FRAMES - resumed_from))
        diffs = {"compiled": _max_diff(comp, vae_loop), "chunk_frames=2": _max_diff(chunk, vae_loop)}
        if any(diffs.values()):
            raise AssertionError(f"33a: the sharded graph modes vs the loop: {diffs}")
        _line("33a seqpar compiled chunked", ok=True, mesh="dp1xsp2", runs=R, frames=SP_FRAMES,
              max_abs_diff=",".join(f"{k}:{v}" for k, v in diffs.items()), launches=0,
              card=repr(card))
        diff = _max_diff(resumed, vae_loop)
        if diff != 0.0 or resumed_from != SP_EVERY or w_shape[0] != R:
            raise AssertionError(f"33b: resumed from {resumed_from} (w {w_shape}), "
                                 f"{diff} from the uninterrupted run")
        saves = [tuple(s_) for s_ in child_saves] + stats["saves"]
        _line("33b seqpar resume SIGKILL", ok=True, mesh="dp1xsp2", runs=R, frames=SP_FRAMES,
              every=SP_EVERY, child_rc=rc, resumed_from=resumed_from, max_abs_diff=diff,
              saved_at=",".join(str(f) for f, _, _ in saves),
              save_gather_ms=",".join(f"{1e3 * g:.3f}" for _, g, _ in saves),
              save_write_ms=",".join(f"{1e3 * w:.3f}" for _, _, w in saves),
              state_bytes=size, launches=0, ranks_call_wall_s=f"{wall:.2f}", card=repr(card))

        _line("33 seqpar options", ok=True, wall_s=f"{time.perf_counter() - t_phase:.1f}",
              card=repr(card))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


RS_DEPTH = 12  # phase 34c's frames of the DP runners and epochs of the VAE-LE's True mode
RS_EPOCHS = 40  # phase 34c's epochs of the one-program AWGN experiments (20 evals)
RS_EVERY = 2  # phase 34d's checkpoint_every: killed in frame 1's progress, after the save at 2


class _RankKill(Exception):
    """Raised from rank 0's ``progress`` to kill a sharded run after a save
    (not a RuntimeError: ``run_ranks`` then stops the other rank at once)."""


def _run_sharding_phases(card: str, flagship: dict, flagship_wall: float) -> None:
    """Phase 34: run sharding (``train/batching.py``). Every runner's runs
    split over a mesh of two gloo ranks sharing the card
    (``make_mesh_2d(2, 1, devices="cuda:0")``), each rank drawing every run
    from the seed, keeping its share, launching its kernels on it and rank 0
    gathering the result, held to the unsharded run bit for bit (max abs
    diff 0.0). Two processes time-slice one card: correctness, not speed.
    (a)-(c) run on one spawn (launches counted per rank, each rank's wall,
    the spawn's seconds); (d) a second. The ranks load the kernels this
    process built: no library under ``build/kernels`` is written again."""
    import dataclasses as dc
    import os
    import tempfile

    import numpy as np

    from vae_equalizer_tpu_torch.ops import _build
    from vae_equalizer_tpu_torch.ops.cma_frame_kernel import cma_chunked_frame
    from vae_equalizer_tpu_torch.ops.cma_kernel import cma_dp_kernel
    from vae_equalizer_tpu_torch.ops.cma_siso_kernel import cma_siso_experiment
    from vae_equalizer_tpu_torch.ops.elbo_kernel import vae_dp_loss_and_grad
    from vae_equalizer_tpu_torch.ops.elbo_siso_kernel import vae_siso_loss_and_grad
    from vae_equalizer_tpu_torch.ops.frame_kernel import vae_dp_frame_train
    from vae_equalizer_tpu_torch.ops.nn_frame_kernel import vae_nn_experiment_train
    from vae_equalizer_tpu_torch.ops.siso_frame_kernel import vae_siso_experiment_train
    from vae_equalizer_tpu_torch.parallel.mesh import make_mesh_2d, run_ranks
    from vae_equalizer_tpu_torch.train import awgn as train_awgn
    from vae_equalizer_tpu_torch.train import dp as train_dp
    from vae_equalizer_tpu_torch.train.batching import runs_call
    from vae_equalizer_tpu_torch.utils import (
        AwgnCmaConfig,
        AwgnVaeLeConfig,
        AwgnVaeNnConfig,
        DpConfig,
    )

    mesh = make_mesh_2d(2, 1, devices=f"{DEVICE}:0")
    where = f"{mesh.n_dp}x{mesh.n_sp} {mesh.backend} on {mesh.devices[0]}"
    libs = {p.name: p.stat().st_mtime_ns for p in _build.BUILD_DIR.glob("*.so")}
    cfg, le = DpConfig(), AwgnVaeLeConfig()
    cut = dc.replace
    cma = lambda v: cut(cfg, loss_type=v, lr=CMA_VARIANTS[v][1], num_frames=RS_DEPTH)  # noqa: E731
    # label: (runner, config, arguments, kernel, launches per rank (and
    # unsharded), the DP channel's frames per rank (each draws every run's
    # levels and runs its own runs' channel))
    cases = {
        "a flagship": (train_dp.train_vae_dp, cfg, dict(runs=8, use_pallas="frame"),
                       vae_dp_frame_train, cfg.num_frames, cfg.num_frames),
        "b flagship compiled": (train_dp.train_vae_dp, cfg,
                                dict(runs=8, use_pallas="frame", compiled=True),
                                vae_dp_frame_train, cfg.num_frames, cfg.num_frames),
        "c VAE True": (train_dp.train_vae_dp, cut(cfg, num_frames=RS_DEPTH),
                       dict(runs=8, use_pallas=True), vae_dp_loss_and_grad,
                       RS_DEPTH * (cfg.n_frame_max // cfg.batch_len), RS_DEPTH),
        **{f"c {v}": (train_dp.run_cma_dp, cma(v), dict(runs=6, use_pallas=CMA_VARIANTS[v][0]),
                      cma_dp_kernel if v == "CMA" else cma_chunked_frame, RS_DEPTH, RS_DEPTH)
           for v in CMA_VARIANTS},
        "c VAE-LE frame": (train_awgn.train_vae_le_awgn, cut(le, num_epochs=RS_EPOCHS),
                           dict(runs=AWGN_RUNS, use_pallas="frame"), vae_siso_experiment_train,
                           1, 0),
        "c VAE-LE True": (train_awgn.train_vae_le_awgn, cut(le, num_epochs=RS_DEPTH),
                          dict(runs=AWGN_RUNS, use_pallas=True), vae_siso_loss_and_grad,
                          RS_DEPTH * (le.n_train // le.batch_len), 0),
        "c VAE-NN Net": (train_awgn.train_vae_nn_awgn, cut(AwgnVaeNnConfig(), num_epochs=RS_EPOCHS),
                         dict(runs=NN_RUNS, use_pallas="frame"), vae_nn_experiment_train, 1, 0),
        "c AWGN CMA": (train_awgn.run_cma_awgn, cut(AwgnCmaConfig(), num_epochs=RS_EPOCHS),
                       dict(runs=CMA_AWGN_RUNS), cma_siso_experiment, 1, 0),
    }
    # (a) and (b) against phase 5's run; phase 5's wall is (a)'s unsharded wall
    refs = {"a flagship": flagship, "b flagship compiled": flagship}
    walls = {"a flagship": flagship_wall}
    for label, (fn, c, kw, kernel, n, ch) in cases.items():
        if label not in refs:
            refs[label], walls[label] = _counted(kernel, n, lambda fn=fn, c=c, kw=kw: fn(
                c, 0, device=DEVICE, **kw), also=_with_channel(ch))

    stats = {label: {} for label in cases}
    calls = [runs_call(fn, c, 0, device=DEVICE, mesh=mesh, stats=stats[label], **kw)
             for label, (fn, c, kw, _, _, _) in cases.items()]
    if any(ranks != mesh for ranks, _ in calls):
        raise AssertionError(f"34: a call not split over both ranks: {[r for r, _ in calls]}")
    t0 = time.time()
    outs = dict(zip(cases, run_ranks(mesh, [call for _, call in calls])))
    wall_call = time.time() - t0
    spawn_s = max(r["start"] for r in stats["a flagship"]["ranks"]) - t0
    for label, (fn, c, kw, kernel, n, ch) in cases.items():
        got, ranks = outs[label], stats[label]["ranks"]
        launches = [r["launches"] for r in ranks]
        # kernel B's frame path evaluates each frame with kernel K; B's windows
        # counter (``ops/frame_kernel.py: WINDOWS``) adds a frame's steps a launch
        steps = c.n_frame_max // c.batch_len
        want = {kernel.__name__: n, **({"vae_dp_frame_eval": n, "vae_dp_frame_windows": n * steps}
                                       if kernel is vae_dp_frame_train else {}),
                **{k.__name__: m for k, m in _with_channel(ch) if m}}
        if any(ln != want for ln in launches):
            raise AssertionError(f"34 {label}: launches per rank {launches}, expected {want} on "
                                 "each")
        diffs = {k: _max_diff(got[k], v) for k, v in refs[label].items()}
        if any(d != 0.0 for d in diffs.values()):
            raise AssertionError(f"34 {label}: sharded vs unsharded max abs diff {diffs}")
        kv = dict(runs=kw["runs"], runs_per_rank=kw["runs"] // 2, launches_per_rank=launches,
                  max_abs_diff=diffs, rank_wall_s=[f"{r['wall_s']:.3f}" for r in ranks])
        if label in walls:
            kv["unsharded_wall_s"] = f"{walls[label]:.3f}"
        if label.startswith("a"):
            soft = float(got["ser"][:, 2:, -20:].mean())
            mi_min = float(got["mi"][:, :, -1].min())
            if not (SER_BAND[0] <= soft <= SER_BAND[1] and mi_min > MI_MIN):
                raise AssertionError(f"34a: soft SER {soft:.5f} (band {SER_BAND}), final MI "
                                     f"{mi_min:.4f} (> {MI_MIN})")
            kv.update(soft_ser_last20=f"{soft:.5f}", mi_final_min=f"{mi_min:.4f}",
                      spawn_s=f"{spawn_s:.2f}")
        _line(f"34{label[0]} run sharding {label[2:]}", ok=True, mesh=where, **kv, card=repr(card))
    rebuilt = {p.name: p.stat().st_mtime_ns for p in _build.BUILD_DIR.glob("*.so")} != libs
    if rebuilt:
        raise AssertionError("34: a rank built the kernels again instead of loading this build")
    _line("34 run sharding call", ok=True, ranks=2, calls=len(cases), wall_s=f"{wall_call:.2f}",
          spawn_s=f"{spawn_s:.2f}", ranks_loaded_the_build=True, card=repr(card))

    # (d) the sharded flagship killed after RS_EVERY frames, resumed without the mesh
    tmp = tempfile.mkdtemp(prefix="phase34_")
    path = os.path.join(tmp, "sharded.npz")

    def killer(frame, m):
        if frame == RS_EVERY - 1:
            raise _RankKill()

    t0 = time.time()
    try:
        train_dp.train_vae_dp(cfg, 0, device=DEVICE, runs=8, use_pallas="frame", mesh=mesh,
                              checkpoint=path, checkpoint_every=RS_EVERY, progress=killer)
    except _RankKill:
        pass
    else:
        raise AssertionError("34d: the sharded run was not killed")
    wall_kill = time.time() - t0
    with np.load(path) as d:
        saved = int(d["frame"])
    resumed, wall_r = _counted(vae_dp_frame_train, cfg.num_frames - saved,
                               lambda: train_dp.train_vae_dp(cfg, 0, device=DEVICE, runs=8,
                                                             use_pallas="frame", checkpoint=path,
                                                             checkpoint_every=RS_EVERY),
                               also=_with_eval(cfg.num_frames - saved))
    d = _max_diff(resumed, flagship)
    if saved != RS_EVERY or d != 0.0:
        raise AssertionError(f"34d: saved at frame {saved} (expected {RS_EVERY}), resumed without "
                             f"the mesh vs uninterrupted max abs diff {d}")
    _line("34d run sharding resume", ok=True, killed_in_frame=RS_EVERY - 1, saved_at=saved,
          file_bytes=os.path.getsize(path), resumed_launches=cfg.num_frames - saved,
          max_abs_diff=d, killed_call_s=f"{wall_kill:.2f}", resumed_wall_s=f"{wall_r:.3f}",
          card=repr(card))


def _awgn_phases(card: str) -> list:
    """Phases 10-12: kernels F and G against their plain versions, then the
    AWGN VAE-LE path in both kernel modes, counted. Returns the kernels' JSON
    entries."""
    import numpy as np
    import torch

    from vae_equalizer_tpu_torch.models import dirac_taps_siso, siso_fir_init, vae_le_siso_forward
    from vae_equalizer_tpu_torch.ops.elbo_siso_kernel import (
        siso_step_clocks,
        vae_siso_loss_and_grad,
        vae_siso_loss_and_grad_plain,
    )
    from vae_equalizer_tpu_torch.ops.siso_frame_kernel import (
        amsgrad,
        siso_clocks,
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
    again = vae_siso_loss_and_grad(*f_args)
    torch.cuda.synchronize()
    if not all(torch.equal(a_, b_) for a_, b_ in zip(got, again)):
        raise AssertionError("kernel F: two launches on the same inputs differ")
    want = vae_siso_loss_and_grad_plain(*f_args)
    errs_f: dict = {}
    _check("loss", got[0], want[0], 1e-5, 0.0, errs_f)
    for name, g_, w_ in zip(("gw", "gh", "q", "out"), got[1:], want[1:]):
        _check(name, g_, w_, 1e-4, 1e-4 * float(w_.abs().max()), errs_f)
    ms_f = _time_ms(lambda: vae_siso_loss_and_grad(*f_args))
    ms_f_launch = _launch_alone_ms(lambda: vae_siso_loss_and_grad(*f_args), "vae_siso_step_launch")
    ms_f_plain = _time_ms(lambda: vae_siso_loss_and_grad_plain(*f_args))
    n_lev = const.num_lev
    bound_f = _bound(R * _siso_step_flops(bl, M, n_lev), _nbytes(f_args, got))
    _line("10 kernel F", ok=True, R=R, bl=bl, errs_abs_rel=_fmt(errs_f), bit_identical=True,
          ms=f"{ms_f:.4f}", launch_ms=f"{ms_f_launch:.4f}", plain_ms=f"{ms_f_plain:.4f}",
          **_clocks_kv(siso_step_clocks(*f_args)))

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
    again = vae_siso_experiment_train(*b_args, **g_kw, step0=step0)
    torch.cuda.synchronize()
    flat = lambda out: [t for o in out for t in (o.values() if isinstance(o, dict) else (o,))]
    if not all(torch.equal(a_, b_) for a_, b_ in zip(flat(got), flat(again))):
        raise AssertionError("kernel G: two launches on the same inputs differ")
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
    out_g = vae_siso_experiment_train(*full_args, **g_kw)  # also the timing's warm-up
    ms_g = _time_ms(lambda: vae_siso_experiment_train(*full_args, **g_kw), reps=3, warmup=False)
    steps_g = cfg.num_epochs * nb
    bound_g = _bound(R * steps_g * (_siso_step_flops(bl, M, n_lev) + 12 * 4 * M),
                     _nbytes(full_args, out_g))
    ms_g_plain = _time_ms(lambda: vae_siso_experiment_train_plain(*full_args, **g_kw), reps=1,
                          warmup=False)
    _line("11b kernel G 10 epochs", ok=True, R=R, step0=step0, errs_abs_rel=_fmt(errs_gb),
          slot_dec_agree=f"{agree:.6f}", bit_identical=True, experiment_ms=f"{ms_g:.3f}",
          experiment_plain_ms=f"{ms_g_plain:.3f}", steps=cfg.num_epochs * nb,
          **_clocks_kv(siso_clocks(*b_args, **g_kw, step0=step0)), card=repr(card))

    # ---- 12. the AWGN path in both kernel modes, counted
    steps = cfg.num_epochs * nb
    expect = {"frame": (vae_siso_experiment_train, 1), True: (vae_siso_loss_and_grad, steps)}
    launches = {}
    n_evals = cfg.num_epochs // cfg.epe
    for mode, (kern, n_expect) in expect.items():
        res, wall = _counted(kern, n_expect, lambda mode=mode: train_awgn.train_vae_le_awgn(
            cfg, seed=0, device=DEVICE, runs=R, use_pallas=mode))
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
              launches=n_expect, ser_last25_median=f"{stats['median']:.6f}",
              ser_last25_converged_mean=f"{stats['converged_mean']:.6f}",
              ser_last25_mean_all=f"{ser25.mean():.6f}", stuck=stats["stuck"], band=AWGN_SER_BAND,
              ser_last25_converged_min_max=f"{ser25[ok].min():.6f}/{ser25[ok].max():.6f}",
              mi_final_min=f"{mi_last.min():.4f}", mi_final_mean=f"{mi_last.mean():.4f}",
              wall_s=f"{wall:.3f}", train_sym_per_s=f"{R * cfg.num_epochs * cfg.n_train / wall:.0f}",
              **split, card=repr(card))

    src = "vae_equalizer_tpu_torch/csrc/siso_kernels.cu"
    return [
        {"name": "vae_siso_loss_and_grad", "route": "cuda", "source": src,
         "replaces": "vae_equalizer_tpu/ops/elbo_siso_kernel.py:283",
         "launches": launches["vae_siso_loss_and_grad"],
         "max_abs_err": max(errs_f["gw"][0], errs_f["gh"][0]), "ms": ms_f, "plain_ms": ms_f_plain,
         **bound_f},
        {"name": "vae_siso_experiment_train", "route": "cuda", "source": src,
         "replaces": "vae_equalizer_tpu/ops/siso_frame_kernel.py:842",
         "launches": launches["vae_siso_experiment_train"], "max_abs_err": g_err, "ms": ms_g,
         "plain_ms": ms_g_plain, **bound_g},
    ]


def _all_counters() -> tuple:
    """Every kernel wrapper's launch counter holder, A-L."""
    from vae_equalizer_tpu_torch.ops import channel_kernel as ck
    from vae_equalizer_tpu_torch.ops.butterfly_kernel import vae_le_dp_forward_fused
    from vae_equalizer_tpu_torch.ops.cma_frame_kernel import cma_chunked_frame
    from vae_equalizer_tpu_torch.ops.cma_kernel import cma_dp_kernel
    from vae_equalizer_tpu_torch.ops.cma_siso_kernel import cma_siso_experiment
    from vae_equalizer_tpu_torch.ops.dfe_kernel import dfe_decide
    from vae_equalizer_tpu_torch.ops.elbo_kernel import vae_dp_loss_and_grad
    from vae_equalizer_tpu_torch.ops.elbo_siso_kernel import vae_siso_loss_and_grad
    from vae_equalizer_tpu_torch.ops.eval_kernel import vae_dp_frame_eval
    from vae_equalizer_tpu_torch.ops.frame_kernel import vae_dp_frame_train
    from vae_equalizer_tpu_torch.ops.nn_frame_kernel import vae_nn_experiment_train
    from vae_equalizer_tpu_torch.ops.siso_frame_kernel import vae_siso_experiment_train

    return (vae_dp_loss_and_grad, vae_dp_frame_train, cma_dp_kernel, cma_chunked_frame,
            vae_le_dp_forward_fused, vae_siso_loss_and_grad, vae_siso_experiment_train,
            vae_nn_experiment_train, cma_siso_experiment, dfe_decide, vae_dp_frame_eval,
            ck.dp_levels, ck.dp_fft_input, ck.dp_mix, ck.dp_noise)


def _with_channel(frames: int, drawn: bool = True) -> tuple:
    """``_counted``'s ``also`` for ``frames`` frames of the DP channel on the
    card: kernel L (``ops/channel_kernel.py``) once a frame, its L4 twice;
    its L1 only where the channel draws the levels (not where a caller's
    ``draws`` hook gives them)."""
    from vae_equalizer_tpu_torch.ops import channel_kernel as ck

    return ((ck.dp_levels, frames if drawn else 0), (ck.dp_fft_input, frames), (ck.dp_mix, frames),
            (ck.dp_noise, 2 * frames))


def _with_eval(frames: int, drawn: bool = True) -> tuple:
    """``_counted``'s ``also`` for a DP VAE / VAEflex frame-mode path of
    ``frames`` frames: kernel K evaluates each frame once, all runs in one
    launch (``train/dp.py: _finish_vae_frame``), after the frame's channel
    (``_with_channel``)."""
    from vae_equalizer_tpu_torch.ops.eval_kernel import vae_dp_frame_eval

    return ((vae_dp_frame_eval, frames),) + _with_channel(frames, drawn)


_LAST_COUNTS: dict = {}  # the launches the last ``_counted`` call read, by wrapper name


def _counted(path_kernel, n_expect: int, fn, also: tuple = ()):
    """Run fn with every launch count at 0; the path must launch path_kernel
    n_expect times, each (kernel, count) of ``also`` count times, and nothing
    else. Returns (fn's result, wall seconds). A path run as CUDA-graph
    replay (``compiled`` / ``chunk_frames``) counts the same: each replay adds
    the launches its capture recorded (``train/harness.py: StepGraphs``),
    i.e. captured launches x replays; the warm-up's are not counted."""
    import torch

    counters = _all_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {c.__name__: c.launches for c in counters}
    _LAST_COUNTS.clear()
    _LAST_COUNTS.update(counts)
    for c in counters:
        c.launches = 0
    expect = {path_kernel.__name__: n_expect, **{k.__name__: n for k, n in also}}
    if any(counts[k] != n for k, n in expect.items()) or sum(counts.values()) != sum(expect.values()):
        raise AssertionError(f"launches {counts}, expected {expect}")
    return res, wall


def _nn_phases(card: str) -> list:
    """Phases 13-14: kernel H against its plain engine (Net and Net_BN), then
    the VAE-NN path in frame mode, counted. Returns the kernels' JSON entries."""
    import numpy as np
    import torch

    from vae_equalizer_tpu_torch.models.vae_nn import vae_nn_forward, vae_nn_init
    from vae_equalizer_tpu_torch.ops import nn_frame_kernel as nfk
    from vae_equalizer_tpu_torch.train import awgn as train_awgn
    from vae_equalizer_tpu_torch.utils import AwgnVaeNnConfig

    dev = torch.device(DEVICE)
    R = NN_RUNS
    entries, stage = [], {}
    for bn_on in (False, True):
        variant = "Net_BN" if bn_on else "Net"
        cfg = AwgnVaeNnConfig(batchnorm=bn_on)
        const, sims, amps, P, _ = train_awgn._setup(cfg, dev, fixed_noise=True)
        M, k1, n_lev = cfg.m_est, cfg.kernel_1, const.num_lev
        ch, nb = 2 * n_lev, cfg.n_train // cfg.batch_len
        gen = torch.Generator(device=dev)
        gen.manual_seed(2024)
        draws = lambda kind, index, runs, sims=sims: sims[kind].draws(gen, runs)
        rx_epochs = lambda n, sims=sims: train_awgn._frame_train_data(sims["train"], draws, R, n)
        g0 = torch.Generator()
        g0.manual_seed(5)
        net, _ = vae_nn_init(g0, k1, cfg.kernel_2, n_lev, bn_on)
        pert = lambda t: (t + 0.01 * torch.randn((R,) + t.shape, generator=g0)).contiguous().to(dev)
        w1f, w2f = (pert(t) for t in nfk.flatten_nn_params(net))
        h0 = torch.zeros((2, M))
        h0[0, M // 2] = 1.0
        h0 = pert(h0)
        bn = None
        if bn_on:
            bn = (torch.stack([torch.ones(R, ch), torch.zeros(R, ch)], -1).to(dev),
                  torch.stack([torch.zeros(R, ch), torch.ones(R, ch)], -1).to(dev))
        opt0 = nfk.nn_frame_opt_init(w1f, w2f, h0, None if bn is None else bn[0])
        kw = dict(bl_sym=cfg.batch_len, n_batches=nb, epe=cfg.epe, k1=k1)
        params = ("w1f", "w2f", "h", "bnp", "rs")
        slots = ((7, "w1_ev"), (8, "w2_ev"), (9, "h_ev"), (10, "bnp_ev"), (11, "rs_ev"))

        # ---- 13a. kernel H vs plain: 2 epochs (26 steps) from a perturbed start
        # (float32 sums in another order: losses rtol 1e-4; parameters, running
        # statistics and eval slots rtol 1e-3 with a 1e-5 floor)
        a_args = (w1f, w2f, h0, opt0, rx_epochs(2), amps, cfg.lr, bn, 0.1)
        got = nfk.vae_nn_experiment_train(*a_args, **kw)
        torch.cuda.synchronize()
        want = nfk.vae_nn_experiment_train_plain(*a_args, **kw)
        errs_a: dict = {}
        _check("losses", got[6], want[6], 1e-4, 0.0, errs_a)
        for i, name in (*enumerate(params), *slots):
            if bn_on or name[:2] not in ("bn", "rs"):
                _check(name, got[i], want[i], 1e-3, 1e-5, errs_a)
        h_err = max(errs_a[k][0] for k in ("w1f", "w2f", "h"))
        _line(f"13a kernel H {variant} 2 epochs", ok=True, R=R, errs_abs_rel=_fmt(errs_a))

        # ---- 13b. 10 epochs from the state after NN_WARM_EPOCHS trained epochs
        warm = nfk.vae_nn_experiment_train(w1f, w2f, h0, opt0, rx_epochs(NN_WARM_EPOCHS), amps,
                                           cfg.lr, bn, 0.1, **kw)
        b_args = (*warm[:3], warm[5], rx_epochs(10), amps, cfg.lr,
                  (warm[3], warm[4]) if bn_on else None, 0.1)
        step0 = NN_WARM_EPOCHS * nb
        got = nfk.vae_nn_experiment_train(*b_args, **kw, step0=step0)
        torch.cuda.synchronize()
        want = nfk.vae_nn_experiment_train_plain(*b_args, **kw, step0=step0)
        errs_b: dict = {}
        _check("losses", got[6], want[6], 1e-3, 0.0, errs_b)
        rx_v, _, _ = sims["valid"](gen, R)

        def decide(out, i):
            net_i = nfk.nn_net(out[7][i], out[8][i], out[10][i], k1, bn_on)
            state = {"mean": out[11][i][..., 0], "var": out[11][i][..., 1], "momentum": 0.1}
            with torch.no_grad():
                q = vae_nn_forward(net_i, rx_v, cfg.sps, state=state, train=False) if bn_on \
                    else vae_nn_forward(net_i, rx_v, cfg.sps)
            return (q[0] if bn_on else q).unflatten(-2, (2, -1)).argmax(-2)

        agree = min(float((decide(got, i) == decide(want, i)).float().mean())
                    for i in range(got[7].shape[0]))
        if agree < 0.999:
            raise AssertionError(f"10-epoch H {variant}: eval-slot decision agreement {agree:.5f}")

        # the kernel against its plain engine over a NN_TIMED_EPOCHS slice; two
        # launches on the same inputs give the same bits; its phase clocks
        t_args = (w1f, w2f, h0, opt0, rx_epochs(NN_TIMED_EPOCHS), amps, cfg.lr, bn, 0.1)
        out_t = nfk.vae_nn_experiment_train(*t_args, **kw)  # also the timing's warm-up
        out_t2 = nfk.vae_nn_experiment_train(*t_args, **kw)
        for x, y in zip(out_t, out_t2):
            for u, v in (zip(x.values(), y.values()) if isinstance(x, dict) else ((x, y),)):
                if not torch.equal(u, v):
                    raise AssertionError(f"kernel H {variant}: two launches on the same inputs differ")
        clocks_h = nfk.nn_clocks(*t_args, **kw)
        ms_h = _time_ms(lambda: nfk.vae_nn_experiment_train(*t_args, **kw), reps=3, warmup=False)
        ms_h_plain = _time_ms(lambda: nfk.vae_nn_experiment_train_plain(*t_args, **kw), reps=1,
                              warmup=False)
        steps_t = NN_TIMED_EPOCHS * nb
        n_par = ch * (2 * k1 + 1) + ch * (3 * ch + 1) + 2 * M + (2 * ch if bn_on else 0)
        bound_h = _bound(R * steps_t * (_nn_step_flops(cfg.batch_len, M, n_lev, k1, bn_on)
                                        + 12 * n_par), _nbytes(t_args, out_t))
        _line(f"13b kernel H {variant} 10 epochs", ok=True, R=R, step0=step0,
              errs_abs_rel=_fmt(errs_b), slot_dec_agree=f"{agree:.6f}",
              slice_epochs=NN_TIMED_EPOCHS, slice_ms=f"{ms_h:.3f}", plain_slice_ms=f"{ms_h_plain:.3f}",
              step_ms=f"{ms_h / steps_t:.4f}", plain_step_ms=f"{ms_h_plain / steps_t:.3f}",
              bound_ms=f"{bound_h['bound_ms']:.4f}", bit_identical=True, **_clocks_kv(clocks_h),
              card=repr(card))
        stage[bn_on] = (cfg, const, sims, amps, P, draws, rx_epochs, (w1f, w2f, h0, opt0, bn))
        entries.append({"name": f"vae_nn_experiment_train[{variant}]", "route": "cuda",
                        "source": "vae_equalizer_tpu_torch/csrc/nn_kernels.cu",
                        "replaces": "vae_equalizer_tpu/ops/nn_frame_kernel.py:500", "launches": None,
                        "max_abs_err": h_err, "ms": ms_h, "plain_ms": ms_h_plain, **bound_h})

    # ---- 14. the VAE-NN path, counted: Net, then Net_BN
    for entry, bn_on in zip(entries, (False, True)):
        cfg, const, sims, amps, P, draws, rx_epochs, start = stage[bn_on]
        variant = "Net_BN" if bn_on else "Net"
        n_evals = cfg.num_epochs // cfg.epe
        res, wall = _counted(nfk.vae_nn_experiment_train, 1, lambda cfg=cfg: train_awgn.train_vae_nn_awgn(
            cfg, seed=0, device=DEVICE, runs=R, use_pallas="frame"))
        entry["launches"] = 1
        for k in ("ser", "mi"):
            if res[k].shape != (R, n_evals) or not np.all(np.isfinite(res[k])):
                raise AssertionError(f"VAE-NN {variant} {k}: shape {res[k].shape} or non-finite values")
        ser25 = res["ser"][:, -25:].mean(-1)
        ok = ser25 <= AWGN_STUCK_SER
        (lo, hi), mi_min = NN_BANDS[bn_on]
        med, conv_mean = float(np.median(ser25)), float(ser25[ok].mean()) if ok.any() else float("nan")
        mi_last = res["mi"][ok, -1] if ok.any() else np.full(1, np.nan)
        if (int((~ok).sum()) > NN_MAX_STUCK or not lo <= med <= hi or not lo <= conv_mean <= hi
                or not np.all(mi_last > mi_min)):
            raise AssertionError(f"VAE-NN {variant}: last-25-evals SER median {med:.6f}, converged "
                                 f"mean {conv_mean:.6f} (band {(lo, hi)}), stuck {int((~ok).sum())} "
                                 f"(at most {NN_MAX_STUCK}), converged final MI min "
                                 f"{mi_last.min():.4f} (floor {mi_min})")
        # channel / kernel / eval split at the path's shapes (CUDA events)
        w1f, w2f, h0, _, bn = start
        st = {}
        kw = dict(bl_sym=cfg.batch_len, n_batches=cfg.n_train // cfg.batch_len, epe=cfg.epe,
                  k1=cfg.kernel_1)

        def channel():
            st["rx"] = rx_epochs(cfg.num_epochs)

        def kernel():
            opt = nfk.nn_frame_opt_init(w1f, w2f, h0, None if bn is None else bn[0])
            st["ev"] = nfk.vae_nn_experiment_train(w1f, w2f, h0, opt, st["rx"], amps, cfg.lr, bn, 0.1,
                                                   **kw)[7:]

        def evaluate():
            w1_ev, w2_ev, _, bnp_ev, rs_ev = st["ev"]
            train_awgn._batched_evals(n_evals, R, draws, lambda sl, vd: train_awgn._nn_evaluate(
                cfg, nfk.nn_net(w1_ev[sl], w2_ev[sl], bnp_ev[sl], cfg.kernel_1, bn_on),
                rs_ev[sl], vd, sims["valid"], const, amps, P))

        ms = [_time_ms(f, reps=1, warmup=False) for f in (channel, kernel, evaluate)]
        _line(f"14 VAE-NN path {variant}", ok=True, runs=R, epochs=cfg.num_epochs, evals=n_evals,
              launches=1, ser_last25_median=f"{med:.6f}", ser_last25_converged_mean=f"{conv_mean:.6f}",
              ser_last25_mean_all=f"{ser25.mean():.6f}", stuck=int((~ok).sum()), band=(lo, hi),
              ser_last25_min_max=f"{ser25.min():.6f}/{ser25.max():.6f}",
              mi_final_min=f"{mi_last.min():.4f}", mi_final_mean=f"{mi_last.mean():.4f}",
              wall_s=f"{wall:.3f}", train_sym_per_s=f"{R * cfg.num_epochs * cfg.n_train / wall:.0f}",
              channel_ms=f"{ms[0]:.3f}", kernel_ms=f"{ms[1]:.3f}", eval_ms=f"{ms[2]:.3f}",
              card=repr(card))
    return entries


def _empty_launch_ms(blocks: int, threads: int, reps: int = 50) -> float:
    """Median CUDA-event time of an empty kernel's launch at the given grid
    (``csrc/butterfly_kernel.cu: butterfly_empty_launch``): the floor of a
    launch on this card, beside kernel E's launch alone."""
    import torch

    from vae_equalizer_tpu_torch.ops import _build

    lib, stream, times = _build.load(), _build.stream(torch.device(DEVICE)), []
    for i in range(reps + 1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _build.check(lib.butterfly_empty_launch(blocks, threads, stream), "butterfly_empty_launch")
        end.record()
        torch.cuda.synchronize()
        if i:  # the first is a warm-up
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def _stream_phases(card: str) -> list:
    """Phases 15-16b: kernel E against its plain version; the streaming
    receiver over a continuous DP stream, counted (one kernel-B launch for
    the adaptation and one kernel-E launch for the output per block), timed
    against the autograd route; route B against the autograd route on block
    0. Returns E's JSON entry and B's on the streaming path."""
    import numpy as np
    import torch

    from vae_equalizer_tpu_torch.channels import channel_ir, make_dp_simulator
    from vae_equalizer_tpu_torch.core import demapper_noise_var, make_constellation
    from vae_equalizer_tpu_torch.metrics import find_shift_dp, ser_iqflip
    from vae_equalizer_tpu_torch.models import butterfly_init
    from vae_equalizer_tpu_torch.models.streaming import StreamingReceiver
    from vae_equalizer_tpu_torch.ops.butterfly_kernel import (
        butterfly_clocks,
        vae_le_dp_forward_fused,
        vae_le_dp_forward_plain,
    )
    from vae_equalizer_tpu_torch.ops.frame_kernel import (
        frame_clocks,
        vae_dp_frame_train,
        vae_dp_frame_train_plain,
    )
    from vae_equalizer_tpu_torch.train.eval_utils import margin_weight_maxshift
    from vae_equalizer_tpu_torch.utils import DpConfig

    dev = torch.device(DEVICE)
    cfg = DpConfig()
    M, block = cfg.m_est, 2000
    const = make_constellation(cfg.mod, cfg.nu)
    amps = torch.from_numpy(const.amps).to(dev)
    P = torch.from_numpy(np.asarray(const.P, np.float32)).to(dev)
    var = torch.full((2,), demapper_noise_var(const, cfg.snr_db), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)

    # ---- 15. kernel E vs plain: one output pass at the streaming shapes (a
    # 2,000-symbol block + the M - 1 tail), sps 2 and sps 1 (float32 sums in
    # another order through the softmin: q rtol 5e-4 / atol 2e-6, out rtol
    # 1e-4 / atol 1e-6, the JAX test's, tests/test_streaming.py:78-79); two
    # launches bit for bit; the whole call, the launch alone beside an empty
    # launch at E's grid (32 symbols, 128 threads a block), and block 0's
    # thread 0 cycles per phase
    e_res = {}
    for sps in (2, 1):
        w = (butterfly_init(M, dev) + 0.05 * torch.randn((2, 4, M), generator=gen, device=dev)).contiguous()
        x = torch.randn((2, 2, M - 1 + block * sps), generator=gen, device=dev)
        e_args = (w, x, amps, var, const.nu_sc, sps)
        got, again = vae_le_dp_forward_fused(*e_args), vae_le_dp_forward_fused(*e_args)
        if not all(torch.equal(u, v) for u, v in zip(got, again)):
            raise AssertionError(f"kernel E sps {sps}: two launches differ")
        torch.cuda.synchronize()
        want = vae_le_dp_forward_plain(*e_args)
        errs: dict = {}
        _check("q", got[0], want[0], 5e-4, 2e-6, errs)
        _check("out", got[1], want[1], 1e-4, 1e-6, errs)
        call = lambda: vae_le_dp_forward_fused(*e_args)  # noqa: E731
        ms_e = _time_ms(call, reps=50)
        ms_launch = _launch_alone_ms(call, "butterfly_demap_launch", reps=50)
        ms_e_plain = _time_ms(lambda: vae_le_dp_forward_plain(*e_args), reps=50)
        n_out = got[1].shape[-1]
        ms_empty = _empty_launch_ms(-(-n_out // 32), 128)
        # per symbol: 4 outputs x 4 rows x M multiply-adds, 4 softmin demappers of ~8 ops per level
        bound_e = _bound(n_out * (4 * 4 * M * 2 + 4 * amps.shape[0] * 8), _nbytes(e_args, got))
        e_res[sps] = (max(errs["q"][0], errs["out"][0]), ms_e, ms_e_plain, bound_e)
        _line(f"15 kernel E sps {sps}", ok=True, n_out=n_out, errs_abs_rel=_fmt(errs), bit_identical=True,
              ms=f"{ms_e:.4f}", launch_ms=f"{ms_launch:.4f}", empty_launch_ms=f"{ms_empty:.4f}",
              plain_ms=f"{ms_e_plain:.4f}", bound_ms=f"{bound_e['bound_ms']:.6f}",
              **_clocks_kv(butterfly_clocks(*e_args)))

    # ---- 16. the streaming path: a continuous stream of STREAM_BLOCKS blocks
    # through route B (one kernel-B launch adapts a block, one kernel-E launch
    # outputs it); the receiver's own time per block from CUDA events around
    # rxr.step (and after its adaptation), apart from the per-block SER
    # evaluation that the wall includes; then the autograd route
    # (use_pallas=False, plain output pass) on the same stream for 3 blocks
    h_up, _ = channel_ir(cfg.channel, cfg.sps)
    sim = make_dp_simulator(const, cfg.snr_db, h_up, STREAM_BLOCKS * block, cfg.sps, cfg.symb_rate,
                            cfg.tau_cd, cfg.tau_pmd, np.asarray(cfg.phi_iq), device=dev)
    rx, tx, _ = sim(gen, float(np.float32(cfg.theta)), 1)
    rx, tx = rx[0], tx[0]
    kw = dict(m_est=M, sps=cfg.sps, block_len=block, lr=cfg.lr, adapt=True, device=DEVICE)
    rxr = StreamingReceiver(amps, P, var, const.nu_sc, use_pallas=True, **kw)
    rxr_ag = StreamingReceiver(amps, P, var, const.nu_sc, use_pallas=False, **kw)
    if (rxr.adapt_route, rxr_ag.adapt_route) != ("B", "autograd"):
        raise AssertionError(f"adapt routes {rxr.adapt_route}, {rxr_ag.adapt_route}: expected B, autograd")
    t_pos = torch.arange(block, device=dev)
    blk = lambda b: rx[:, :, b * block * cfg.sps : (b + 1) * block * cfg.sps]
    events = []  # per block: before step, after its adaptation, after step

    def mark_adapt(r):
        adapt = r.adapt_block

        def marked(state, b_):
            state = adapt(state, b_)
            events[-1][1].record()
            return state
        r.adapt_block = marked

    def run_stream(r, n_blocks, ser=True):
        state, sers = r.init(), []
        for b in range(n_blocks):
            events.append([torch.cuda.Event(enable_timing=True) for _ in range(3)])
            events[-1][0].record()
            state, q, _ = r.step(state, blk(b))
            events[-1][2].record()
            if ser:
                txb = tx[:, :, b * block : (b + 1) * block]
                shift, rot = find_shift_dp(q, txb, 21, amps)
                q = torch.roll(q, int(rot), dims=0)
                q = torch.stack([torch.roll(q[i], -int(shift[i]), dims=-1) for i in range(2)])
                wgt = margin_weight_maxshift(block, int(shift.abs().max()), t=t_pos)
                sers.append(float(ser_iqflip(q, txb, weight=wgt).mean()))
        return state, np.asarray(sers)

    def split_ms():
        torch.cuda.synchronize()
        ms = np.asarray([[a.elapsed_time(b), b.elapsed_time(c)] for a, b, c in events])
        events.clear()
        return ms.sum(1), ms[:, 0], ms[:, 1]

    mark_adapt(rxr)
    (state, sers), wall = _counted(vae_le_dp_forward_fused, STREAM_BLOCKS,
                                   lambda: run_stream(rxr, STREAM_BLOCKS),
                                   also=((vae_dp_frame_train, STREAM_BLOCKS),))
    blk_ms, adapt_ms, out_ms = split_ms()
    last = sers[-10:]
    settled = int(np.argmax(sers < AWGN_STUCK_SER)) if np.any(sers < AWGN_STUCK_SER) else -1
    if not (STREAM_BAND[0] <= last.mean() <= STREAM_BAND[1] and last.max() <= STREAM_BLOCK_MAX):
        raise AssertionError(f"streaming: last-10-block SER mean {last.mean():.6f} (band {STREAM_BAND}), "
                             f"max {last.max():.6f} (at most {STREAM_BLOCK_MAX}); first block below "
                             f"{AWGN_STUCK_SER}: {settled}")
    del rxr.adapt_block  # the receiver's own method again
    blk0 = blk(0).contiguous()
    adapt_call = lambda: rxr.adapt_block(state, blk0)  # noqa: E731
    ms_adapt = _time_ms(adapt_call, reps=20)
    ms_b_launch = _launch_alone_ms(adapt_call, "vae_dp_frame_launch", reps=20)
    with torch.no_grad():
        ms_out = _time_ms(lambda: rxr.output_block(state, blk0), reps=20)
    # the autograd route on the same stream, 3 blocks after a warm-up step,
    # timed as the route B blocks were (no kernel launched)
    rxr_ag.step(rxr_ag.init(), blk0)
    mark_adapt(rxr_ag)
    _, wall_ag = _counted(vae_dp_frame_train, 0, lambda: run_stream(rxr_ag, 3, ser=False))
    ag_ms, ag_adapt_ms, ag_out_ms = split_ms()
    del rxr_ag.adapt_block
    med = lambda a: f"{float(np.median(a)):.4f}"  # noqa: E731
    _line("16 streaming path", ok=True, mod=cfg.mod, blocks=STREAM_BLOCKS, block=block,
          adapt_route=rxr.adapt_route, kernel_b_launches=STREAM_BLOCKS, kernel_e_launches=STREAM_BLOCKS,
          ser_last10_mean=f"{last.mean():.6f}", ser_last10_max=f"{last.max():.6f}", band=STREAM_BAND,
          first_block_below_0p05=settled, wall_s=f"{wall:.3f}",
          block_wall_ms=f"{1e3 * wall / STREAM_BLOCKS:.3f}", rx_block_ms_median=med(blk_ms),
          rx_block_ms_mean=f"{blk_ms.mean():.4f}", rx_block_ms_max=f"{blk_ms.max():.4f}",
          rx_adapt_ms_median=med(adapt_ms), rx_output_ms_median=med(out_ms),
          adapt_block_ms=f"{ms_adapt:.4f}", b_launch_alone_ms=f"{ms_b_launch:.4f}",
          output_block_ms=f"{ms_out:.4f}", autograd_block_ms=",".join(f"{v:.3f}" for v in ag_ms),
          autograd_adapt_ms=",".join(f"{v:.3f}" for v in ag_adapt_ms),
          autograd_output_ms=",".join(f"{v:.3f}" for v in ag_out_ms), autograd_wall_s=f"{wall_ag:.3f}",
          card=repr(card))

    # ---- 16b. route B against the autograd route on block 0 from the Dirac
    # start: 20 Adam steps, under the ~150 at which two roundings part, but
    # from zero moments, whose first steps amplify rounding (a sign flip of a
    # ~0 gradient moves a tap by ~lr). So each of taps, moments, q and out is
    # held to 4x the distance at which the autograd route parts from itself
    # with w moved by 1e-7 (relative) on the same block: phase 18b's rule,
    # doubled for the cold start (on the card the two routes part by 0.7-2.0x
    # that distance; q's largest gap sits where an output lies between two
    # levels and the softmin's 1 / (2 var) ~ 80 magnifies out's)
    runs = {}
    for name, r, w_scale in (("B", rxr, 1.0), ("autograd", rxr_ag, 1.0), ("perturbed", rxr_ag, 1 + 1e-7)):
        st0 = r.init()
        st0["params"]["w"] = st0["params"]["w"] * w_scale
        st1, q1, o1 = r.step(st0, blk0)
        runs[name] = {**st1["params"], **{k: st1["opt"][k] for k in ("mw", "vw", "mh", "vh")},
                      "q": q1, "out": o1}
    errs_r: dict = {}
    pert = {k: float((runs["perturbed"][k] - v).abs().max()) for k, v in runs["autograd"].items()}
    for k, v in runs["autograd"].items():
        _check(k, runs["B"][k], v, 0.0, 4 * pert[k], errs_r)
    _line("16b stream B vs autograd", ok=True, steps=block // rxr.adapt_batch, errs_abs_rel=_fmt(errs_r),
          perturbed_autograd_abs=",".join(f"{k}:{v:.2e}" for k, v in pert.items()),
          ratio=",".join(f"{k}:{errs_r[k][0] / pert[k]:.2f}" for k in pert))


    # kernel B at the streaming shapes (R = 1, 20 windows of 100 symbols)
    # against its plain version, from the stream's final state on block 0:
    # phase 4b's criteria (losses rtol 1e-3, decisions 99.9 % equal)
    one = lambda t: t[None]  # noqa: E731
    b_args = (one(state["params"]["w"]), one(state["params"]["h"]),
              {k: one(state["opt"][k]) for k in ("mw", "vw", "mh", "vh")}, one(blk0), amps,
              *rxr._b_consts, state["opt"]["step"], float("inf"))
    got = vae_dp_frame_train(*b_args, bl_sym=rxr.adapt_batch)
    torch.cuda.synchronize()
    want = vae_dp_frame_train_plain(*b_args, bl_sym=rxr.adapt_batch)
    errs_bs: dict = {}
    _check("losses", got[3], want[3], 1e-3, 0.0, errs_bs)
    agree = float((got[6] == want[6]).float().mean())
    if agree < 0.999:
        raise AssertionError(f"streaming kernel B: dec agreement {agree:.5f} < 0.999")
    taps_err = max(float((got[i] - want[i]).abs().max()) for i in (0, 1))
    ms_bs = _time_ms(lambda: vae_dp_frame_train(*b_args, bl_sym=rxr.adapt_batch), reps=20)
    ms_bs_plain = _time_ms(lambda: vae_dp_frame_train_plain(*b_args, bl_sym=rxr.adapt_batch), reps=5)
    m_b = got[3].shape[0]
    bound_bs = _bound(m_b * (_dp_step_flops(rxr.adapt_batch, M, amps.shape[0]) + 12 * 16 * M),
                      _nbytes(b_args, got))
    _line("16c kernel B streaming", ok=True, R=1, steps=m_b, errs_abs_rel=_fmt(errs_bs), taps_abs=f"{taps_err:.2e}",
          dec_agree=f"{agree:.6f}", ms=f"{ms_bs:.4f}", plain_ms=f"{ms_bs_plain:.3f}",
          bound_ms=f"{bound_bs['bound_ms']:.6f}",
          **_clocks_kv(frame_clocks(*b_args, bl_sym=rxr.adapt_batch)))
    err, ms_e, ms_e_plain, bound_e = e_res[2]
    return [{"name": "vae_le_dp_forward_fused", "route": "cuda",
             "source": "vae_equalizer_tpu_torch/csrc/butterfly_kernel.cu",
             "replaces": "vae_equalizer_tpu/ops/butterfly_kernel.py:135", "launches": STREAM_BLOCKS,
             "max_abs_err": max(err, e_res[1][0]), "ms": ms_e, "plain_ms": ms_e_plain, **bound_e},
            {"name": "vae_dp_frame_train[streaming]", "route": "cuda",
             "source": "vae_equalizer_tpu_torch/csrc/dp_kernels.cu",
             "replaces": "vae_equalizer_tpu/ops/frame_kernel.py:1024", "launches": STREAM_BLOCKS,
             "max_abs_err": taps_err, "ms": ms_bs, "plain_ms": ms_bs_plain, **bound_bs}]


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


def _step_path_phase(card, cfg, sim, gen, thetas, w0, h0, const, amps, var, P) -> int:
    """Phase 17: the flagship per-step path, train_vae_dp(use_pallas=True),
    counted (kernel A once per minibatch for all runs), gated like phase 5;
    its per-frame split; use_pallas=False (autograd) for its frame time.
    Returns kernel A's launch count on the path."""
    import numpy as np
    import torch

    from vae_equalizer_tpu_torch.ops.elbo_kernel import vae_dp_loss_and_grad
    from vae_equalizer_tpu_torch.ops.frame_kernel import adam_update, frame_opt_init
    from vae_equalizer_tpu_torch.train import dp as train_dp
    from vae_equalizer_tpu_torch.train.eval_utils import BatchCutWeight

    R, bl = w0.shape[0], cfg.batch_len
    m_max = cfg.n_frame_max // bl
    n_expect = cfg.num_frames * m_max
    res, wall = _counted(vae_dp_loss_and_grad, n_expect, lambda: train_dp.train_vae_dp(
        cfg, seed=0, device=DEVICE, use_pallas=True, runs=R), also=_with_channel(cfg.num_frames))
    for k in ("ser", "mi", "var_est"):
        if not np.all(np.isfinite(res[k])):
            raise AssertionError(f"per-step path: non-finite {k}")
    if res["ser"].shape != (R, 4, cfg.num_frames):
        raise AssertionError(f"per-step path: result shape {res['ser'].shape}")
    soft = float(res["ser"][:, 2:, -20:].mean())
    mi_last = res["mi"][:, :, -1]
    if not SER_BAND[0] <= soft <= SER_BAND[1] or not np.all(mi_last > MI_MIN):
        raise AssertionError(f"per-step path: last-20-frame soft SER {soft:.5f} (band {SER_BAND}), "
                             f"final MI min {mi_last.min():.3f} (floor {MI_MIN})")

    # per-frame split at the path's shapes (CUDA events): the channel, the
    # frame's 100 kernel A launches, its 100 Adam updates, the q-stream eval
    st = {}
    params = {"w": w0, "h": h0}
    wfn = BatchCutWeight(m_max, bl, cfg.n_cut)

    def channel():
        st["ch"] = sim(gen, thetas[0], R)

    def kernel_steps():
        rx = st["ch"][0]
        st["k"] = [vae_dp_loss_and_grad(w0, h0, rx[..., 2 * bl * m : 2 * bl * (m + 1)], amps, var,
                                        const.nu_sc, P) for m in range(m_max)]

    def adam():
        p, o = params, frame_opt_init(params)
        for k in st["k"]:
            p, o = adam_update(p, o, {"w": k[2], "h": k[3]}, cfg.lr, 0)

    def evaluate():
        k = list(zip(*st["k"]))
        train_dp._finish_step_frame(torch.stack(k[0]), torch.cat(k[4], -1), torch.cat(k[5], -1),
                                    torch.stack(k[1], -2), st["ch"][1], const, amps, P, var, wfn,
                                    st["ch"][2])

    ms = [_time_ms(f) for f in (channel, kernel_steps, adam, evaluate)]
    cfg2 = dataclasses.replace(cfg, num_frames=2)
    _, wall_f = _counted(vae_dp_loss_and_grad, 0, lambda: train_dp.train_vae_dp(
        cfg2, seed=0, device=DEVICE, use_pallas=False, runs=R), also=_with_channel(2))
    _line("17 per-step path", ok=True, runs=R, frames=cfg.num_frames, kernel_a_launches=n_expect,
          soft_ser_last20=f"{soft:.5f}", const_ser_last20=f"{float(res['ser'][:, :2, -20:].mean()):.5f}",
          mi_final_min=f"{mi_last.min():.4f}", wall_s=f"{wall:.3f}",
          sym_per_s=f"{R * cfg.num_frames * m_max * bl / wall:.0f}",
          frame_wall_ms=f"{1e3 * wall / cfg.num_frames:.3f}", channel_ms=f"{ms[0]:.3f}",
          kernel_a_steps_ms=f"{ms[1]:.3f}", adam_ms=f"{ms[2]:.3f}", eval_ms=f"{ms[3]:.3f}",
          autograd_frame_wall_ms=f"{1e3 * wall_f / 2:.3f}", card=repr(card))
    return n_expect


def _vaeflex_phases(card, cfg, sim, gen, w0, h0, const, amps, var, P) -> list:
    """Phases 18-20: kernel B's stride form against its plain version, the
    VAEflex frame path (kernel B, stride_sym = flex_step) counted and gated by
    the JAX band, then VAEflex's per-step kernel A mode against it on shared
    draws. Returns the stride form's JSON entry."""
    import numpy as np
    import torch

    from vae_equalizer_tpu_torch.models import butterfly_init, dirac_taps_dp
    from vae_equalizer_tpu_torch.ops.elbo_kernel import vae_dp_loss_and_grad
    from vae_equalizer_tpu_torch.ops.frame_kernel import (
        frame_clocks,
        frame_opt_init,
        vae_dp_frame_train,
        vae_dp_frame_train_plain,
    )
    from vae_equalizer_tpu_torch.train import dp as train_dp
    from vae_equalizer_tpu_torch.train.eval_utils import MarginWeight

    dev = torch.device(DEVICE)
    R, M, bl, fs = w0.shape[0], cfg.m_est, cfg.batch_len, cfg.flex_step
    n_frame = cfg.n_frame_max // bl * bl
    n_win = (n_frame - bl) // fs
    nu_sc, lr, n_lev = const.nu_sc, cfg.lr, amps.shape[0]
    thresh = float(cfg.n_lrhalf * n_win)
    thetas = train_dp._frame_inputs(dataclasses.replace(cfg, num_frames=WARM_FRAMES + 1), dev)

    # ---- 18a. 3 windows from the perturbed Dirac start, w lr halving at the
    # 2nd: phase 4a's tolerances
    rx = sim(gen, thetas[0], R)[0]
    opt0 = frame_opt_init({"w": w0, "h": h0})
    rx3 = rx[..., : 2 * (3 * fs + bl)].contiguous()  # (130 - 100) // 10 = 3 windows
    b_args = (w0, h0, opt0, rx3, amps, var, nu_sc, P, lr, 40, 41.0)
    got = vae_dp_frame_train(*b_args, bl_sym=bl, stride_sym=fs)
    torch.cuda.synchronize()
    want = vae_dp_frame_train_plain(*b_args, bl_sym=bl, stride_sym=fs)
    if got[3].shape != (3, R):
        raise AssertionError(f"stride form: losses shape {tuple(got[3].shape)}, expected (3, {R})")
    errs: dict = {}
    dec_mis = _check_b3(got, want, amps, var, nu_sc, 1e-6, errs)
    err_b = max(errs["w"][0], errs["h"][0])
    _line("18a kernel B stride 3 windows", ok=True, R=R, stride_sym=fs, errs_abs_rel=_fmt(errs),
          dec_tie_mismatch=dec_mis)

    # ---- 18b. one full frame of n_win windows from the state after
    # WARM_FRAMES frames. Every window is a dependent Adam step, and past ~150
    # of them two float32 roundings of the same training part ways (the plain
    # version against itself with w moved by 1e-7 relative does it too):
    # the first 100 windows hold phase 4b's tolerances; the whole frame may
    # part from the plain version at most twice as far as the plain version
    # parts from itself so perturbed
    wk = butterfly_init(M, dev).expand(R, 2, 4, M).contiguous()
    hk = dirac_taps_dp(M, dev).expand(R, 2, 2, 2, M).contiguous()
    optk = frame_opt_init({"w": wk, "h": hk})
    for f in range(WARM_FRAMES):
        rx_f = sim(gen, thetas[f], R)[0]
        wk, hk, optk = vae_dp_frame_train(wk, hk, optk, rx_f, amps, var, nu_sc, P, lr, f * n_win,
                                          thresh, bl_sym=bl, stride_sym=fs)[:3]
    rx_f = sim(gen, thetas[WARM_FRAMES], R)[0]
    f_args = (wk, hk, optk, rx_f, amps, var, nu_sc, P, lr, WARM_FRAMES * n_win, thresh)
    got = vae_dp_frame_train(*f_args, bl_sym=bl, stride_sym=fs)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = vae_dp_frame_train_plain(*f_args, bl_sym=bl, stride_sym=fs)
    end.record()
    torch.cuda.synchronize()
    ms_plain = start.elapsed_time(end)
    gen_p = torch.Generator(device=dev)
    gen_p.manual_seed(5)
    wk_p = wk * (1 + 1e-7 * torch.randn(wk.shape, generator=gen_p, device=dev))
    want_p = vae_dp_frame_train_plain(wk_p, *f_args[1:], bl_sym=bl, stride_sym=fs)
    rel = lambda a, b: float(((a - b).abs() / b.abs()).max())
    agree = lambda a, b: float((a == b).float().mean())
    errs_f: dict = {}
    _check("losses_first100", got[3][:100], want[3][:100], 1e-3, 0.0, errs_f)
    agree100 = agree(got[6][:100], want[6][:100])
    loss_rel, loss_rel_pp = rel(got[3], want[3]), rel(want_p[3], want[3])
    agree_all, agree_pp = agree(got[6], want[6]), agree(want_p[6], want[6])
    if agree100 < 0.999 or loss_rel > 2 * loss_rel_pp + 1e-3 or \
            1 - agree_all > 2 * (1 - agree_pp) + 1e-3:
        raise AssertionError(f"{n_win}-window frame: first-100 dec agreement {agree100:.5f}; whole "
                             f"frame losses rel {loss_rel:.3e} (plain vs perturbed plain "
                             f"{loss_rel_pp:.3e}), dec agreement {agree_all:.5f} ({agree_pp:.5f})")
    ms_b = _time_ms(lambda: vae_dp_frame_train(*f_args, bl_sym=bl, stride_sym=fs), reps=3)
    bound_b = _bound(R * n_win * (_dp_step_flops(bl, M, n_lev) + 12 * 16 * M), _nbytes(f_args, got))
    _line(f"18b kernel B stride {n_win} windows", ok=True, R=R, errs_abs_rel=_fmt(errs_f),
          dec_agree_first100=f"{agree100:.6f}", losses_rel_all=f"{loss_rel:.3e}",
          losses_rel_plain_perturbed=f"{loss_rel_pp:.3e}", dec_agree_all=f"{agree_all:.6f}",
          dec_agree_plain_perturbed=f"{agree_pp:.6f}", ms=f"{ms_b:.3f}", plain_ms=f"{ms_plain:.3f}",
          bound_ms=f"{bound_b['bound_ms']:.6f}",
          **_clocks_kv(frame_clocks(*f_args, bl_sym=bl, stride_sym=fs)), card=repr(card))

    # ---- 19. the VAEflex frame path, counted, gated by the JAX band
    res, wall = _counted(vae_dp_frame_train, cfg.num_frames, lambda: train_dp.train_vae_flex_dp(
        cfg, seed=0, device=DEVICE, use_pallas="frame", runs=R), also=_with_eval(cfg.num_frames))
    for k in ("ser", "mi", "var_est"):
        if not np.all(np.isfinite(res[k])):
            raise AssertionError(f"VAEflex: non-finite {k}")
    if res["ser"].shape != (R, 4, cfg.num_frames):
        raise AssertionError(f"VAEflex: result shape {res['ser'].shape}")
    soft = float(res["ser"][:, 2:, -20:].mean())
    mi_run = res["mi"][:, :, -1].mean(-1)  # (R,) final MI, mean of the pols
    (lo, hi), (mlo, mhi), mi_floor = VAEFLEX_SER_BAND, VAEFLEX_MI_BAND, VAEFLEX_MI_FLOOR
    if not lo <= soft <= hi or not mlo <= float(mi_run.mean()) <= mhi or not np.all(mi_run > mi_floor):
        raise AssertionError(f"VAEflex: last-20-frame soft SER {soft:.5f} (band {VAEFLEX_SER_BAND}), "
                             f"final MI mean {mi_run.mean():.4f} (band {VAEFLEX_MI_BAND}), min "
                             f"{mi_run.min():.4f} (floor {mi_floor})")
    st = {}
    wfn = MarginWeight(n_win * fs)
    crop = slice((bl - fs) // 2, (bl - fs) // 2 + fs)
    # kernel K against the plain eval on this path's streams: a fresh frame
    # through the taps the path trained, cropped, its tx cut and masked as
    # the runner does
    wt, ht = (res["params"][k].to(dev).contiguous() for k in ("w", "h"))
    rx_t, tx_t, _ = sim(gen, thetas[WARM_FRAMES], R)
    kt = vae_dp_frame_train(wt, ht, frame_opt_init({"w": wt, "h": ht}), rx_t, amps, var, nu_sc, P,
                            lr, 0, 1e9, bl_sym=bl, stride_sym=fs)
    k_mi_err = _eval_vs_plain("19 VAEflex", tuple(a[..., crop] for a in kt[5:10]) + (
        tx_t[..., bl // 2 : bl // 2 + n_win * fs], amps, P, nu_sc, var, wfn))[1]

    def channel():
        st["ch"] = sim(gen, thetas[0], R)

    def kernel():
        st["k"] = vae_dp_frame_train(w0, h0, opt0, st["ch"][0], amps, var, nu_sc, P, lr, 0, 1e9,
                                     bl_sym=bl, stride_sym=fs)

    def evaluate():
        k, (_, tx, sigma) = st["k"], st["ch"]
        out, dec, eq, mm, s1 = (a[..., crop] for a in (k[5], k[6], k[7], k[8], k[9]))
        train_dp._finish_vae_frame(k[3], out, k[4], tx[..., bl // 2 : bl // 2 + n_win * fs], amps,
                                   P, var, nu_sc, const.pow_mean, wfn, sigma, dec, eq, mm, s1)

    ms = [_time_ms(f) for f in (channel, kernel, evaluate)]
    _line("19 VAEflex path", ok=True, runs=R, frames=cfg.num_frames, windows=n_win,
          kernel_b_launches=cfg.num_frames, soft_ser_last20=f"{soft:.5f}",
          const_ser_last20=f"{float(res['ser'][:, :2, -20:].mean()):.5f}", band=VAEFLEX_SER_BAND,
          mi_final_mean=f"{mi_run.mean():.4f}", mi_final_min=f"{mi_run.min():.4f}",
          wall_s=f"{wall:.3f}", sym_per_s=f"{R * cfg.num_frames * n_frame / wall:.0f}",
          frame_wall_ms=f"{1e3 * wall / cfg.num_frames:.3f}", channel_ms=f"{ms[0]:.3f}",
          kernel_b_ms=f"{ms[1]:.3f}", eval_ms=f"{ms[2]:.3f}", kernel_k_launches=cfg.num_frames,
          kernel_k_vs_plain=f"equal,mi_abs_err:{k_mi_err:.3g}", card=repr(card))

    # ---- 20. VAEflex use_pallas=True (kernel A per window) against "frame" on
    # shared draws, FLEX_CHECK_FRAMES frames from the taps phase 19 trained:
    # from a cold start the two roundings part within the first frame and
    # converge frames apart, so the check starts from trained taps (Adam's
    # moments start at zero in both). The JAX test's coarse tolerances
    # (tests/test_frame_kernel.py:198-206): SER atol 0.05 per frame (the mean
    # over runs in the re-converging first frame), w atol 0.05
    cfg5 = dataclasses.replace(cfg, num_frames=FLEX_CHECK_FRAMES)
    gen_d = torch.Generator(device=dev)
    gen_d.manual_seed(77)
    draws = [sim.draws(gen_d, R) for _ in range(FLEX_CHECK_FRAMES)]
    run = lambda mode: train_dp.train_vae_flex_dp(cfg5, seed=0, device=DEVICE, use_pallas=mode, runs=R,
                                                  params_init=res["params"],
                                                  draws=lambda frame, r: draws[frame])
    res_k, wall_k = _counted(vae_dp_loss_and_grad, FLEX_CHECK_FRAMES * n_win, lambda: run(True),
                             also=_with_channel(FLEX_CHECK_FRAMES, drawn=False))
    res_b, wall_b = _counted(vae_dp_frame_train, FLEX_CHECK_FRAMES, lambda: run("frame"),
                             also=_with_eval(FLEX_CHECK_FRAMES, drawn=False))
    d_ser = np.abs(res_k["ser"] - res_b["ser"])
    d_ser_first = float(np.abs(res_k["ser"][..., 0].mean(0) - res_b["ser"][..., 0].mean(0)).max())
    d_w = float((res_k["params"]["w"] - res_b["params"]["w"]).abs().max())
    if float(d_ser[..., 1:].max()) > 0.05 or d_ser_first > 0.05 or d_w > 0.05:
        raise AssertionError(f"VAEflex True vs frame: SER diff {d_ser[..., 1:].max():.4f} (frames 2-), "
                             f"{d_ser_first:.4f} (frame 1, run mean), w diff {d_w:.4f}")
    _line("20 VAEflex per-step", ok=True, runs=R, frames=FLEX_CHECK_FRAMES,
          kernel_a_launches=FLEX_CHECK_FRAMES * n_win, ser_diff_max=f"{d_ser[..., 1:].max():.5f}",
          ser_diff_frame1_run_mean=f"{d_ser_first:.5f}", w_diff_max=f"{d_w:.5f}",
          soft_ser_true=f"{res_k['ser'][:, 2:, -1].mean():.5f}",
          soft_ser_frame=f"{res_b['ser'][:, 2:, -1].mean():.5f}",
          frame_wall_ms_true=f"{1e3 * wall_k / FLEX_CHECK_FRAMES:.3f}",
          frame_wall_ms_frame=f"{1e3 * wall_b / FLEX_CHECK_FRAMES:.3f}", card=repr(card))
    return [{"name": "vae_dp_frame_train[stride]", "route": "cuda",
             "source": "vae_equalizer_tpu_torch/csrc/dp_kernels.cu",
             "replaces": "vae_equalizer_tpu/ops/frame_kernel.py:1024", "launches": cfg.num_frames,
             "max_abs_err": err_b, "ms": ms_b, "plain_ms": ms_plain, **bound_b}]


def _per_run_phase(card, cfg, sim, gen, w0, h0, const, amps, P, f_args) -> dict:
    """Phase 21: kernel B with per-run lr / var / nu_sc / P against its plain
    version, against its own shared form, and with stream_bf16. ``f_args``:
    phase 4b's warm 100-step frame (shared constants). Returns the per-run
    form's timing and errors."""
    import numpy as np
    import torch

    from vae_equalizer_tpu_torch.core import make_constellation
    from vae_equalizer_tpu_torch.ops.frame_kernel import (
        frame_opt_init,
        vae_dp_frame_train,
        vae_dp_frame_train_plain,
    )
    from vae_equalizer_tpu_torch.train.eval_utils import BatchCutWeight

    dev = torch.device(DEVICE)
    R, bl, n_lev = w0.shape[0], cfg.batch_len, amps.shape[0]
    nus = (0.0, 0.0270955) * (R // 2)
    snrs = np.arange(16.0, 16.0 + R)
    consts = [make_constellation(cfg.mod, nu) for nu in nus]
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    rc = {"lr": T([2.5e-3, 2e-3, 3e-3, 1.5e-3, 2.25e-3, 2.75e-3, 1e-3, 3.5e-3][:R]),
          "var": T([[c.pow_mean / 10 ** (s / 10) / 2] * 2 for c, s in zip(consts, snrs)]),
          "nu_sc": T([c.nu_sc for c in consts]), "P": T(np.stack([c.P for c in consts]))}
    names = ("w", "h", "opt", "losses", "var_est", "out", "dec", "eq", "mm", "s1")
    flat = lambda res: {**{k: v for k, v in zip(names, res) if k != "opt"}, **res[2]}

    # ---- 21a. 3 minibatches from the perturbed start, w lr halving at the
    # 2nd, every run with its own constants: phase 4a's tolerances, but for
    # eq = sum_l q_l a_l an absolute floor of 1e-5: where the posterior
    # splits between +-a its terms cancel, and the output's ~3e-7 rounding
    # through the softmin's (out - a) / var (x80 at 16 dB) leaves ~1e-6 to
    # 3e-6 there (measured on the card: 2.6e-6 at |eq| 4e-3, one element of
    # 4,800); 21b holds every run's row to the shared form bit for bit
    rx3 = sim(gen, 0.3, R)[0][..., : 3 * 2 * bl].contiguous()
    a_args = (w0, h0, frame_opt_init({"w": w0, "h": h0}), rx3, amps, rc["var"], rc["nu_sc"], rc["P"],
              rc["lr"], 40, 41.0)
    got = vae_dp_frame_train(*a_args, bl_sym=bl)
    torch.cuda.synchronize()
    want = vae_dp_frame_train_plain(*a_args, bl_sym=bl)
    errs: dict = {}
    dec_mis = _check_b3(got, want, amps, rc["var"], rc["nu_sc"], 1e-5, errs)
    _line("21a kernel B per-run 3 steps", ok=True, R=R, errs_abs_rel=_fmt(errs), dec_tie_mismatch=dec_mis)

    # ---- 21b. bit for bit on the card: constant vectors against the shared
    # form (phase 4b's warm frame), and run r of a per-run call against a
    # one-run call with run r's constants in the shared form
    wk, hk, optk, rx_f, _, var, nu_sc, _, lr, step0, thresh = f_args
    shared = flat(vae_dp_frame_train(*f_args, bl_sym=bl))
    vec = flat(vae_dp_frame_train(wk, hk, optk, rx_f, amps, var.expand(R, 2).contiguous(),
                                  torch.full((R,), nu_sc, device=dev), P.expand(R, n_lev).contiguous(),
                                  torch.full((R,), lr, device=dev), step0, thresh, bl_sym=bl))
    bad = [k for k in shared if not torch.equal(shared[k], vec[k])]
    b_args = (wk, hk, optk, rx_f, amps, rc["var"], rc["nu_sc"], rc["P"], rc["lr"], step0, thresh)
    per_run = flat(vae_dp_frame_train(*b_args, bl_sym=bl))
    for r in (0, 1, R - 1):
        sl = slice(r, r + 1)
        one = flat(vae_dp_frame_train(wk[sl], hk[sl], {k: v[sl] for k, v in optk.items()}, rx_f[sl],
                                      amps, rc["var"][r], float(rc["nu_sc"][r]), rc["P"][r],
                                      float(rc["lr"][r]), step0, thresh, bl_sym=bl))
        runs_first = ("w", "h", "mw", "vw", "mh", "vh")
        bad += [f"row {r} {k}" for k in one
                if not torch.equal(per_run[k][sl] if k in runs_first else per_run[k][:, sl], one[k])]
    if bad:
        raise AssertionError(f"kernel B per-run constants: not bit for bit: {bad}")

    # ---- 21c. stream_bf16: training and mm / s1 unchanged, out / eq the
    # float32 values rounded to bfloat16 (within 2^-8 relative), dec exact
    bf = flat(vae_dp_frame_train(*b_args, bl_sym=bl, stream_bf16=True))
    bad = [k for k in ("w", "h", "mw", "vw", "mh", "vh", "losses", "var_est", "mm", "s1")
           if bf[k].dtype != torch.float32 or not torch.equal(bf[k], per_run[k])]
    bad += [k for k in ("out", "dec", "eq") if bf[k].dtype != torch.bfloat16]
    bad += [k for k in ("out", "eq") if not torch.equal(bf[k], per_run[k].to(torch.bfloat16))]
    bad += ["dec"] if not torch.equal(bf["dec"].to(torch.int32), per_run["dec"]) else []
    rel = max(float(((bf[k].float() - per_run[k]).abs() / per_run[k].abs().clamp_min(1e-30)).max())
              for k in ("out", "eq"))
    if bad or rel > 2.0**-8:
        raise AssertionError(f"stream_bf16: {bad}, out/eq max rel {rel:.3e}")
    ms_shared = _time_ms(lambda: vae_dp_frame_train(*f_args, bl_sym=bl))
    ms_vec = _time_ms(lambda: vae_dp_frame_train(*b_args, bl_sym=bl))
    ms_bf = _time_ms(lambda: vae_dp_frame_train(*b_args, bl_sym=bl, stream_bf16=True))
    ms_plain = _time_ms(lambda: vae_dp_frame_train_plain(*b_args, bl_sym=bl), reps=1, warmup=False)
    m_max = rx_f.shape[-1] // (2 * bl)
    bound = _bound(R * m_max * (_dp_step_flops(bl, cfg.m_est, n_lev) + 12 * 16 * cfg.m_est),
                   _nbytes(b_args, list(per_run.values())))
    _line("21b-c kernel B per-run bit for bit, stream_bf16", ok=True, R=R,
          bf16_out_eq_max_rel=f"{rel:.3e}", ms_shared=f"{ms_shared:.3f}", ms_per_run=f"{ms_vec:.3f}",
          ms_bf16=f"{ms_bf:.3f}", plain_ms=f"{ms_plain:.3f}", bound_ms=f"{bound['bound_ms']:.6f}",
          card=repr(card))

    # ---- 21d. kernel K against the plain eval on kernel B's streams of a
    # fresh frame from phase 4b's warm state, every run with its own P / var /
    # nu_sc, float32 and stream_bf16 streams
    rx_d, tx_d, _ = sim(gen, 0.3, R)
    wfn = BatchCutWeight(m_max, bl, cfg.n_cut)
    d_args = (wk, hk, optk, rx_d, amps, rc["var"], rc["nu_sc"], rc["P"], rc["lr"], step0, thresh)
    k_mi = {}
    for name, bf16 in (("float32", False), ("bf16", True)):
        kd = vae_dp_frame_train(*d_args, bl_sym=bl, stream_bf16=bf16)
        k_mi[name] = _eval_vs_plain(f"21d per-run {name}", (*kd[5:10], tx_d, amps, rc["P"],
                                                            rc["nu_sc"], rc["var"], wfn))[1]
    _line("21d kernel K per-run, stream_bf16", ok=True, R=R, ser_shift_r="equal",
          mi_abs_err=",".join(f"{k}:{v:.3g}" for k, v in k_mi.items()), card=repr(card))
    return {"max_abs_err": max(errs["w"][0], errs["h"][0]), "ms": ms_vec, "plain_ms": ms_plain, **bound}


def _soft20(ser, axis_sl):
    """Per grid point: the mean over iters of the last-20-frame soft SER
    (rows 2:4 of the .mat's SER), the points along ``axis_sl``."""
    return ser[(slice(2, 4),) + axis_sl].reshape(2, -1, ser.shape[-2], ser.shape[-1])[..., -20:] \
        .mean(axis=(0, 2, 3))


def _sweep_phases(card, cfg, const, amps, var, w0, h0, per_run) -> dict:
    """Phases 22-24: the Eval_run_DP driver's batched lr / SNR / nu sweeps at
    its defaults, counted (one kernel B launch per frame for the whole grid)
    and held to the JAX package's accuracy; 22 also unbatched. Returns the
    per-run kernel's JSON entry."""
    import glob
    import os
    import shutil
    import tempfile

    import numpy as np
    import scipy.io as sio
    import torch

    from vae_equalizer_tpu_torch.drivers import eval_run_dp
    from vae_equalizer_tpu_torch.ops.frame_kernel import frame_opt_init, vae_dp_frame_train
    from vae_equalizer_tpu_torch.train import dp as train_dp
    from vae_equalizer_tpu_torch.train.eval_utils import BatchCutWeight
    from vae_equalizer_tpu_torch.utils import io

    dev = torch.device(DEVICE)
    bl, iters, n_frame = cfg.batch_len, 5, cfg.n_frame_max
    m_max = n_frame // bl
    sim = train_dp._setup(cfg, n_frame, dev)[2]
    keys = ["SER", "Var_est", "var_real", "SNR", "nu", "theta_diff", "theta", "M", "lr",
            "batch_len", "symb_rate", "symb_step"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sweep_")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4242)
    wfn = BatchCutWeight(m_max, bl, cfg.n_cut)
    theta = float(np.float32(cfg.theta))

    def sweep(name, argv, n_launch):
        """One driver run, counted: (SER (4, grid..., iters, frames), the
        records, wall seconds)."""
        out = os.path.join(tmp, name)
        mat, wall = _counted(vae_dp_frame_train, n_launch, lambda: eval_run_dp.main(
            ["--loss-type", "VAE", "--pallas-frame", "--out", out] + argv),
            also=_with_eval(n_launch))
        d = sio.loadmat(mat)["dict"]
        if list(d.dtype.names) != keys:
            raise AssertionError(f"{name}: .mat keys {d.dtype.names}")
        recs = io.read_jsonl(glob.glob(os.path.join(out, "sweep_*.jsonl"))[0])
        return {k: d[k][0, 0] for k in keys}, recs, wall

    def split(R, lr_vec=None, snr_vec=None, nu_vec=None):
        """Per-frame channel / kernel B / eval ms at a sweep's shapes and run
        constants (CUDA events)."""
        rc = train_dp._run_consts(cfg, const, var, R, lr_vec, snr_vec, nu_vec, dev)
        w, h = (t[:1].expand((R,) + t.shape[1:]).contiguous() for t in (w0, h0))
        opt, st = frame_opt_init({"w": w, "h": h}), {}

        def channel():
            st["ch"] = sim.physics(theta, *sim.draws(gen, R, rc["P_draw"]), rc["snr_lin"])

        def kernel():
            st["k"] = vae_dp_frame_train(w, h, opt, st["ch"][0], amps, rc["var"], rc["nu_sc"], rc["P"],
                                         rc["lr"], 0, 1e9, bl_sym=bl)

        def evaluate():
            k, (_, tx, sigma) = st["k"], st["ch"]
            train_dp._finish_vae_frame(k[3], k[5], k[4], tx, amps, rc["P"], rc["var"], rc["nu_sc"],
                                       rc["pow_mean"], wfn, sigma, k[6], k[7], k[8], k[9])

        ms = [_time_ms(f) for f in (channel, kernel, evaluate)]
        return dict(channel_ms=f"{ms[0]:.3f}", kernel_b_ms=f"{ms[1]:.3f}", eval_ms=f"{ms[2]:.3f}")

    speed = lambda R, wall: dict(wall_s=f"{wall:.3f}", sym_per_s=f"{R * cfg.num_frames * n_frame / wall:.0f}",
                                 frame_wall_ms=f"{1e3 * wall / cfg.num_frames:.3f}")

    # ---- 22. the lr sweep: 3 lr x 5 iters as one call, then unbatched
    lrs = list(LR_SWEEP_SER)
    mat, _, wall = sweep("lr", ["--batch-lr-axis"], cfg.num_frames)
    if mat["SER"].shape != (4, 1, 1, 1, 1, 1, 3, 1, 1, iters, cfg.num_frames):
        raise AssertionError(f"lr sweep: SER shape {mat['SER'].shape}")
    soft = _soft20(mat["SER"], (0, 0, 0, 0, 0, slice(None)))
    mat_u, _, wall_u = sweep("lr_unbatched", [], 3 * cfg.num_frames)
    soft_u = _soft20(mat_u["SER"], (0, 0, 0, 0, 0, slice(None)))
    ref = np.asarray([LR_SWEEP_SER[lr] for lr in lrs])
    if not np.all(np.isfinite(mat["SER"])) or np.abs(soft - ref).max() > SWEEP_TOL \
            or np.abs(soft_u - soft).max() > SWEEP_TOL:
        raise AssertionError(f"lr sweep: soft SER {soft} (JAX {ref}, +-{SWEEP_TOL}), unbatched {soft_u}")
    _line("22 lr sweep", ok=True, runs=3 * iters, frames=cfg.num_frames, kernel_b_launches=cfg.num_frames,
          lr=lrs, soft_ser_last20=[round(float(x), 5) for x in soft],
          unbatched_soft_ser_last20=[round(float(x), 5) for x in soft_u],
          unbatched_kernel_b_launches=3 * cfg.num_frames, unbatched_wall_s=f"{wall_u:.3f}",
          **speed(3 * iters, wall), **split(3 * iters, lr_vec=np.repeat(lrs, iters)), card=repr(card))

    # ---- 23. the SER-vs-SNR curve: 8 SNRs x 5 iters as one call
    snrs = list(SNR_CURVE_SER)
    mat, _, wall = sweep("snr", ["--batch-snr-axis", "--snr", *map(str, snrs), "--lr", "2.5e-3"],
                         cfg.num_frames)
    soft = _soft20(mat["SER"], (slice(None),))
    ref = np.asarray([SNR_CURVE_SER[s] for s in snrs])
    var_real = mat["var_real"][0, :, 0, 0, 0, 0, 0, 0, 0, 0, 0]  # pol x, per SNR point
    want_var = np.asarray([np.float32(const.pow_mean / 10 ** (s / 10) / 2) for s in snrs])
    if np.any(np.abs(soft - ref) > np.maximum(SWEEP_TOL, 0.1 * ref)) or np.any(np.diff(soft) >= 0) \
            or not np.array_equal(var_real, want_var):
        raise AssertionError(f"SNR curve: soft SER {soft} (JAX {ref}), var_real {var_real} ({want_var})")
    _line("23 SNR curve", ok=True, runs=len(snrs) * iters, frames=cfg.num_frames,
          kernel_b_launches=cfg.num_frames, snr_db=snrs, soft_ser_last20=[round(float(x), 5) for x in soft],
          jax_soft_ser=[float(x) for x in ref], **speed(len(snrs) * iters, wall),
          **split(len(snrs) * iters, snr_vec=np.repeat(snrs, iters)), card=repr(card))

    # ---- 24. the nu sweep: 2 nu x 5 iters as one call
    nus = list(NU_SWEEP)
    mat, recs, wall = sweep("nu", ["--batch-nu-axis", "--nu", *map(str, nus), "--lr", "2.5e-3"],
                            cfg.num_frames)
    soft = _soft20(mat["SER"], (0, 0, slice(None)))
    mi = [float(np.asarray(r["mi"])[..., -20:].mean()) for r in sorted(recs, key=lambda r: r["coords"])]
    for nu, s, m in zip(nus, soft, mi):
        if abs(s - NU_SWEEP[nu][0]) > SWEEP_TOL or not m > NU_SWEEP[nu][1]:
            raise AssertionError(f"nu sweep: nu {nu}: soft SER {s:.5f} (JAX {NU_SWEEP[nu][0]} +-{SWEEP_TOL}), "
                                 f"MI {m:.4f} (floor {NU_SWEEP[nu][1]})")
    _line("24 nu sweep", ok=True, runs=len(nus) * iters, frames=cfg.num_frames,
          kernel_b_launches=cfg.num_frames, nu=nus, soft_ser_last20=[round(float(x), 5) for x in soft],
          mi_last20=[round(m, 4) for m in mi], **speed(len(nus) * iters, wall),
          **split(len(nus) * iters, nu_vec=np.repeat(nus, iters)), card=repr(card))
    shutil.rmtree(tmp, ignore_errors=True)

    # the per-run form at the SNR curve's 40 runs: one 100-step frame
    R = len(snrs) * iters
    rc = train_dp._run_consts(cfg, const, var, R, None, np.repeat(snrs, iters), None, dev)
    w, h = (t[:1].expand((R,) + t.shape[1:]).contiguous() for t in (w0, h0))
    t_args = (w, h, frame_opt_init({"w": w, "h": h}), sim(gen, theta, R)[0], amps, rc["var"],
              rc["nu_sc"], rc["P"], rc["lr"], 0, 1e9)
    got = vae_dp_frame_train(*t_args, bl_sym=bl)
    ms = _time_ms(lambda: vae_dp_frame_train(*t_args, bl_sym=bl))
    bound = _bound(R * m_max * (_dp_step_flops(bl, cfg.m_est, amps.shape[0]) + 12 * 16 * cfg.m_est),
                   _nbytes(t_args, got))
    _line("24 kernel B per-run", R=R, ms=f"{ms:.3f}", bound_ms=f"{bound['bound_ms']:.6f}",
          card=repr(card))
    return {"name": "vae_dp_frame_train[per-run]", "route": "cuda",
            "source": "vae_equalizer_tpu_torch/csrc/dp_kernels.cu",
            "replaces": "vae_equalizer_tpu/ops/frame_kernel.py:1024", "launches": 3 * cfg.num_frames,
            **per_run}


def _eval_vs_plain(label: str, args) -> tuple:
    """Kernel K against the plain eval (``train/dp.py: _dp_frame_eval_mb``) on
    the same inputs (``vae_dp_frame_eval``'s arguments): SERs, shift and r
    equal, MI within 1e-6 bits. Returns (K's results, the MI's largest
    distance)."""
    import torch

    from vae_equalizer_tpu_torch.ops.eval_kernel import vae_dp_frame_eval
    from vae_equalizer_tpu_torch.train import dp as train_dp

    got = vae_dp_frame_eval(*args)
    want = train_dp._dp_frame_eval_mb(*args)
    for name, g, w in zip(("ser_const", "ser_soft", "shift", "r"), got[:2] + got[3:],
                          want[:2] + want[3:]):
        if not torch.equal(g, w.to(g.dtype)):
            raise AssertionError(f"{label}: kernel K's {name} {g.tolist()} vs plain {w.tolist()}")
    mi_err = float((got[2] - want[2]).abs().max())
    if mi_err > 1e-6:
        raise AssertionError(f"{label}: kernel K's MI {mi_err:.3g} bits from the plain version's")
    return got, mi_err


def _eval_kernel_phase(card: str, launches: int) -> dict:
    """Phase 6b: kernel K (``ops/eval_kernel.py``) against the plain eval
    (``train/dp.py: _dp_frame_eval_mb``) on kernel B's streams of one
    flagship frame of 8 runs, from the state after WARM_FRAMES trained
    frames: SERs, shift and r equal, MI within 1e-6 bits; two launches bit
    for bit; the whole call's and the launch's times beside the bound, the
    plain version's time and its kernel count (torch.profiler); K's launches
    on a 12-frame run of the frame path, looped and replayed, counted (one a
    frame); block 0's clock64() cycles per phase (eval_clocks). Returns K's
    JSON entry, with ``launches`` (phase 5's counted K launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vae_equalizer_tpu_torch.ops.eval_kernel import SYNC_CORR_LEN, eval_clocks, vae_dp_frame_eval
    from vae_equalizer_tpu_torch.ops.frame_kernel import vae_dp_frame_train
    from vae_equalizer_tpu_torch.train import dp as train_dp
    from vae_equalizer_tpu_torch.train.eval_utils import BatchCutWeight
    from vae_equalizer_tpu_torch.utils import DpConfig

    dev = torch.device(DEVICE)
    cfg, R = DpConfig(), 8
    bl = cfg.batch_len
    m_max = cfg.n_frame_max // bl
    const, var, sim, amps, P = train_dp._setup(cfg, m_max * bl, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    thetas, f_args = _warm_frame_args(cfg, sim, gen, const, amps, var, P, R, dev)
    rx, tx, _ = sim(gen, thetas[WARM_FRAMES], R)  # a fresh frame, with its tx
    k = vae_dp_frame_train(*f_args[:3], rx, *f_args[4:], bl_sym=bl)
    args = (k[5], k[6], k[7], k[8], k[9], tx, amps, P, const.nu_sc, var,
            BatchCutWeight(m_max, bl, cfg.n_cut))
    got, mi_err = _eval_vs_plain("6b kernel K", args)
    again = vae_dp_frame_eval(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("kernel K: two launches on the same inputs differ")
    ms = _time_ms(lambda: vae_dp_frame_eval(*args), reps=20)
    ms_launch = _launch_alone_ms(lambda: vae_dp_frame_eval(*args), "vae_dp_eval_launch", reps=20)
    ms_plain = _time_ms(lambda: train_dp._dp_frame_eval_mb(*args), reps=5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        train_dp._dp_frame_eval_mb(*args)
        torch.cuda.synchronize()
    plain_kernels = sum(e.count for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
    bound = _bound(R * _eval_flops(m_max * bl, amps.shape[0], SYNC_CORR_LEN),
                   _nbytes(args[:6], got))
    frames = {}
    for compiled in (False, True):  # _counted: kernels B and K 12 times each, nothing else
        _counted(vae_dp_frame_train, 12, lambda compiled=compiled: train_dp.train_vae_dp(
            dataclasses.replace(cfg, num_frames=12), seed=0, device=DEVICE, runs=R,
            use_pallas="frame", compiled=compiled), also=_with_eval(12))
        frames[compiled] = _LAST_COUNTS["vae_dp_frame_eval"]
    _line("6b kernel K", ok=True, R=R, mi_abs_err=f"{mi_err:.3g}", bit_identical=True,
          ser_soft=",".join(f"{v:.5f}" for v in got[1].flatten().tolist()),
          shift=got[3].tolist(), r=got[4].tolist(), ms=f"{ms:.4f}", launch_ms=f"{ms_launch:.4f}",
          plain_ms=f"{ms_plain:.3f}", plain_kernels=plain_kernels,
          bound_ms=f"{bound['bound_ms']:.6f}", bound_by=bound["bound_by"],
          launches_12_frames=frames, card=repr(card), **_clocks_kv(eval_clocks(*args)))
    return {"name": "vae_dp_frame_eval", "route": "cuda",
            "source": "vae_equalizer_tpu_torch/csrc/dp_eval_kernel.cu",
            "replaces": "none (vae_equalizer_tpu/train/dp.py:187-214, plain jnp)",
            "launches": launches, "max_abs_err": mi_err, "ms": ms, "plain_ms": ms_plain,
            **bound}


# phase 6c's cases: (label, runs, per run): the flagship's R = 8 at the
# configured SNR, the SNR curve's 40 runs at 16..23 dB x 5 repeats (the
# sweep cell's), and 8 runs at two nu (a per-run pmf)
CHANNEL_CASES = (("r8_shared", 8, None), ("r40_snr", 40, "snr"), ("r8_pmf", 8, "pmf"))


def _channel_inputs(cfg, R: int, per_run, dev) -> tuple:
    """A CHANNEL_CASES case's (per-run linear SNR (R,) on ``dev`` or None,
    per-run pmf (R, n) or None)."""
    import numpy as np
    import torch

    from vae_equalizer_tpu_torch.core import make_constellation

    snr = P = None
    if per_run == "snr":
        db = np.repeat(np.arange(16.0, 24.0), R // 8).astype(np.float32)
        snr = torch.from_numpy((10.0 ** (np.float64(db) / 10.0)).astype(np.float32)).to(dev)
    if per_run == "pmf":
        P = np.stack([np.asarray(make_constellation(cfg.mod, (0.0, 0.0270955)[r % 2]).P,
                                 np.float32) for r in range(R)])
    return snr, P


def _device_kernels(fn, reps: int) -> tuple:
    """(device ms, device kernels) a call of ``fn`` over ``reps`` calls, from
    torch.profiler (CUPTI; nan where it shows none); copies and sets left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.key.startswith(("Memcpy", "Memset"))]
    us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
             for e in evs)
    return (1e-3 * us / reps if us > 0 else float("nan")), sum(e.count for e in evs) / reps


def _channel_phase(card: str, frames: int) -> dict:
    """Phase 6c: kernel L (``ops/channel_kernel.py``: the DP channel around
    cuFFT) against the plain channel (``DpSimulator.draws_plain`` /
    ``physics_plain``) on the card, at the flagship frame's length, for each
    of CHANNEL_CASES, on the same generator state: levels and noise, the FFT
    input, the forward transform, H zf CD and tx bit for bit; the inverse
    transform unnormalized and scaled by the float32 1 / fft_len bit for bit
    with the plain ifft; sigma's ulps (0 but at a float32 tie of its float64
    sum); rx's share of elements bit for bit and its largest gap relative to
    each run's rms (at most 1e-6). Then each path's device time and kernels
    a frame (draws and physics; torch.profiler), its CUDA-event time, and
    kernel L's launches a frame (one each, L4 two).
    Returns kernel L's JSON entry (the R = 8 case's times), with
    ``launches`` the frames of phase 5's path (each five launches)."""
    import numpy as np
    import torch

    from vae_equalizer_tpu_torch.ops import _build
    from vae_equalizer_tpu_torch.ops import channel_kernel as ck
    from vae_equalizer_tpu_torch.train import dp as train_dp
    from vae_equalizer_tpu_torch.utils import DpConfig

    dev = torch.device(DEVICE)
    cfg = DpConfig()
    sim = train_dp._setup(cfg, cfg.n_frame_max // cfg.batch_len * cfg.batch_len, dev)[2]
    theta = torch.tensor(np.float32(cfg.theta + 3 * cfg.theta_diff), device=dev)
    scale = np.float32(1.0 / sim.fft_len).item()
    entry = None
    for i, (label, R, per_run) in enumerate(CHANNEL_CASES):
        snr, P = _channel_inputs(cfg, R, per_run, dev)
        gens = [torch.Generator(device=dev) for _ in range(2)]
        for g in gens:
            g.manual_seed(6060 + i)
        lev, noi = sim.draws_kernel(gens[0], R, P)
        lev_p, noi_p = sim.draws_plain(gens[1], R, P)
        z_in = ck.dp_fft_input(lev, sim.sps, sim.up_len, sim.fft_len)
        up = sim.upsampled_plain(lev)
        zf, zf_p = torch.fft.fft(z_in, dim=-1), torch.fft.fft(up, n=sim.fft_len, dim=-1)
        mixed = ck.dp_mix(zf.clone(), theta, *sim._e_host, sim._d0, sim._d1, sim._cd)
        mixed_p = sim.mix_plain(theta, zf_p)
        inv = torch.fft.ifft(mixed_p, dim=-1)
        inv_f = torch.fft.ifft(mixed_p, dim=-1, norm="forward")
        rx, tx, sig = sim.physics_kernel(theta, lev, noi, snr)
        rx_p, tx_p, sig_p = sim.physics_plain(theta, lev, noi, snr)
        exact = {"levels": torch.equal(lev, lev_p), "noise": torch.equal(noi, noi_p),
                 "fft_input": torch.equal(z_in[..., : sim.up_len], up)
                 and not bool(z_in[..., sim.up_len:].abs().max() > 0),
                 "forward": torch.equal(zf, zf_p), "mix": torch.equal(mixed, mixed_p),
                 "scaling": torch.equal(torch.complex(inv_f.real * scale, inv_f.imag * scale), inv),
                 "tx": torch.equal(tx, tx_p)}
        rx_same = float((rx == rx_p).double().mean())
        ulps = (sig.view(torch.int32) - sig_p.view(torch.int32)).abs()
        rms = rx_p.square().mean(dim=(1, 2, 3)).sqrt()
        rx_gap = float(((rx - rx_p).abs().amax(dim=(1, 2, 3)) / rms).max())
        if not all(exact.values()) or int(ulps.max()) > 1 or rx_gap > 1e-6:
            raise AssertionError(f"6c {label}: kernel L vs plain: bit for bit {exact}, sigma ulps "
                                 f"{ulps.tolist()}, rx gap {rx_gap:.3g} of rms (at most 1e-6)")

        def kernel_frame():
            return sim.physics_kernel(theta, *sim.draws_kernel(gens[0], R, P), snr)

        def plain_frame():
            return sim.physics_plain(theta, *sim.draws_plain(gens[1], R, P), snr)

        state = _build.launch_state()
        kernel_frame()
        launches = {w.__name__: n for w, n in _build.launches_since(state).items()}
        if launches != {"dp_levels": 1, "dp_fft_input": 1, "dp_mix": 1, "dp_noise": 2}:
            raise AssertionError(f"6c {label}: kernel L's launches a frame {launches}")
        dev_ms, kernels = _device_kernels(kernel_frame, 10)
        dev_ms_p, kernels_p = _device_kernels(plain_frame, 10)
        ms, ms_p = _time_ms(kernel_frame, reps=20), _time_ms(plain_frame, reps=20)
        # L1 the uniforms in, the levels out; L2 the levels in, the FFT input out;
        # L3 the transform in and out; L4 the inverse transform twice (a bound
        # of its window), the noise in, rx out
        bound = _bound(0, _nbytes(lev, lev, lev, z_in, zf, zf, inv, inv, noi, rx))
        _line(f"6c kernel L {label}", ok=True, runs=R, bit_identical=",".join(exact),
              sigma_ulps_max=int(ulps.max()), sigma_differ=int((ulps > 0).sum()),
              rx_bit_identical_share=f"{rx_same:.6f}", rx_gap_of_rms=f"{rx_gap:.3g}",
              device_ms=f"{dev_ms:.4f}", plain_device_ms=f"{dev_ms_p:.4f}", kernels=f"{kernels:.1f}",
              plain_kernels=f"{kernels_p:.1f}", ms=f"{ms:.4f}",
              plain_ms=f"{ms_p:.4f}", bound_ms=f"{bound['bound_ms']:.6f}", card=repr(card))
        if entry is None:
            entry = {"name": "dp_channel", "route": "cuda",
                     "source": "vae_equalizer_tpu_torch/csrc/dp_channel_kernel.cu",
                     "replaces": "none (vae_equalizer_tpu/channels/optical_dp.py, plain jnp)",
                     "launches": 5 * frames, "max_abs_err": rx_gap, "ms": ms, "plain_ms": ms_p,
                     **bound}
    return entry


def _warm_frame_args(cfg, sim, gen, const, amps, var, P, R: int, dev) -> tuple:
    """Phase 4b's inputs: (the frames' thetas, kernel B's arguments for one
    full frame of R runs from the state after WARM_FRAMES frames of training
    from the Dirac start, on ``gen``'s draws)."""
    from vae_equalizer_tpu_torch.models import butterfly_init, dirac_taps_dp
    from vae_equalizer_tpu_torch.ops.frame_kernel import frame_opt_init, vae_dp_frame_train
    from vae_equalizer_tpu_torch.train import dp as train_dp

    warm, M, bl = WARM_FRAMES, cfg.m_est, cfg.batch_len
    m_max = cfg.n_frame_max // bl
    thetas = train_dp._frame_inputs(dataclasses.replace(cfg, num_frames=warm + 1), dev)
    wk = butterfly_init(M, dev).expand(R, 2, 4, M).contiguous()
    hk = dirac_taps_dp(M, dev).expand(R, 2, 2, 2, M).contiguous()
    optk, thresh = frame_opt_init({"w": wk, "h": hk}), float(cfg.n_lrhalf * m_max)
    for f in range(warm):
        rx_f, _, _ = sim(gen, thetas[f], R)
        wk, hk, optk = vae_dp_frame_train(wk, hk, optk, rx_f, amps, var, const.nu_sc, P, cfg.lr,
                                          f * m_max, thresh, bl_sym=bl)[:3]
    rx_f, _, _ = sim(gen, thetas[warm], R)
    return thetas, (wk, hk, optk, rx_f, amps, var, const.nu_sc, P, cfg.lr, warm * m_max, thresh)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import numpy as np

    from vae_equalizer_tpu_torch.models import butterfly_init, dirac_taps_dp
    from vae_equalizer_tpu_torch.ops import _build
    from vae_equalizer_tpu_torch.models.cma import chunk_schedule
    from vae_equalizer_tpu_torch.ops.cma_frame_kernel import (
        cma_chunked_clocks,
        cma_chunked_frame,
        cma_chunked_frame_plain,
    )
    from vae_equalizer_tpu_torch.ops.cma_kernel import cma_dp_clocks, cma_dp_kernel, cma_dp_plain
    from vae_equalizer_tpu_torch.ops.elbo_kernel import vae_dp_loss_and_grad, vae_dp_loss_and_grad_plain
    from vae_equalizer_tpu_torch.ops.frame_kernel import (
        frame_clocks,
        frame_opt_init,
        vae_dp_frame_train,
        vae_dp_frame_train_plain,
    )
    from vae_equalizer_tpu_torch.train import dp as train_dp
    from vae_equalizer_tpu_torch.train.eval_utils import BatchCutWeight, MarginWeight
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

    # ---- 3. kernel A vs plain: one minibatch of all R = 8 runs in one launch,
    # read in place from the frame rows as the per-step path does (rtol 1e-4:
    # float32 sums in another order)
    x1 = rx[..., 2 * bl : 4 * bl]
    a_args = (w0, h0, x1, amps, var, nu_sc, P)
    got = vae_dp_loss_and_grad(*a_args)
    torch.cuda.synchronize()
    want = vae_dp_loss_and_grad_plain(*a_args)
    errs_a: dict = {}
    for name, g, w in zip(("loss", "var_est", "gw", "gh", "q", "out"), got, want):
        _check(name, g, w, 1e-4, 1e-4 * float(w.abs().max()), errs_a)
    ms_a = _time_ms(lambda: vae_dp_loss_and_grad(*a_args), reps=20)
    ms_a_plain = _time_ms(lambda: vae_dp_loss_and_grad_plain(*a_args), reps=20)
    n_lev = amps.shape[0]
    bound_a = _bound(R * _dp_step_flops(bl, M, n_lev), _nbytes(a_args, got))
    _line("3 kernel A", ok=True, R=R, errs_abs_rel=_fmt(errs_a), ms=f"{ms_a:.4f}",
          plain_ms=f"{ms_a_plain:.4f}", bound_ms=f"{bound_a['bound_ms']:.6f}")

    # ---- 4a. kernel B vs plain: 3 minibatches, R = 8, w lr halves at the 2nd
    opt0 = frame_opt_init({"w": w0, "h": h0})
    rx3 = rx[..., : 3 * 2 * bl].contiguous()
    b_args = (w0, h0, opt0, rx3, amps, var, nu_sc, P, lr, 40, 41.0)
    got = vae_dp_frame_train(*b_args, bl_sym=bl)
    torch.cuda.synchronize()
    want = vae_dp_frame_train_plain(*b_args, bl_sym=bl)
    errs_b: dict = {}
    dec_mis = _check_b3(got, want, amps, var, nu_sc, 1e-6, errs_b)
    b_err = max(errs_b["w"][0], errs_b["h"][0])
    _line("4a kernel B 3 steps", ok=True, R=R, errs_abs_rel=_fmt(errs_b), dec_tie_mismatch=dec_mis)

    # ---- 4b. one full 100-step frame at flagship lr, from the state after 20
    # frames of training (from a cold start, Adam's first steps amplify
    # rounding chaotically: zero moments turn sign flips of ~0 gradients into
    # +-lr updates); times
    thetas, f_args = _warm_frame_args(cfg, sim, gen, const, amps, var, P, R, dev)
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
    # + Adam: ~12 ops per parameter (w 8M, h 8M) and step
    bound_b = _bound(R * m_max * (_dp_step_flops(bl, M, n_lev) + 12 * 16 * M), _nbytes(f_args, got))
    _line("4b kernel B 100 steps", ok=True, R=R, errs_abs_rel=_fmt(errs_f), dec_agree=f"{agree:.6f}",
          ms=f"{ms_b:.3f}", plain_ms=f"{ms_b_plain:.3f}",
          **_clocks_kv(frame_clocks(*f_args, bl_sym=bl)))

    # ---- 5. the main path, counted
    res, wall = _counted(vae_dp_frame_train, cfg.num_frames, lambda: train_dp.train_vae_dp(
        cfg, seed=0, device=DEVICE, use_pallas="frame", runs=R), also=_with_eval(cfg.num_frames))
    flagship, flagship_wall = res, wall  # phase 34's unsharded reference
    launches_b, launches_k, launches_l = (_LAST_COUNTS[k] for k in (
        "vae_dp_frame_train", "vae_dp_frame_eval", "dp_mix"))
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
          kernel_k_launches=launches_k, kernel_l_frames=launches_l,
          soft_ser_last20=f"{soft:.5f}", const_ser_last20=f"{float(res['ser'][:, :2, -20:].mean()):.5f}",
          mi_final_min=f"{mi_last.min():.4f}", wall_s=f"{wall:.3f}", sym_per_s=f"{sym_s:.0f}",
          card=repr(card))

    # ---- 6. per-frame breakdown at the main path's shapes (CUDA events)
    opt = frame_opt_init({"w": w0, "h": h0})
    wfn = BatchCutWeight(m_max, bl, cfg.n_cut)
    state = {}

    def channel():
        state["ch"] = sim(gen, thetas[0], R)

    def kernel():
        state["k"] = vae_dp_frame_train(w0, h0, opt, state["ch"][0], amps, var, nu_sc, P, lr, 0,
                                        1e9, bl_sym=bl)

    def evaluate():
        k = state["k"]
        train_dp._finish_vae_frame(k[3], k[5], k[4], state["ch"][1], amps, P, var, nu_sc,
                                   const.pow_mean, wfn, state["ch"][2], k[6], k[7], k[8], k[9])

    ms_ch, ms_k, ms_ev = _time_ms(channel), _time_ms(kernel), _time_ms(evaluate)
    _line("6 breakdown", runs=R, channel_ms=f"{ms_ch:.3f}", kernel_b_ms=f"{ms_k:.3f}",
          eval_ms=f"{ms_ev:.3f}", frame_wall_ms=f"{1e3 * wall / cfg.num_frames:.3f}")
    eval_kernel = _eval_kernel_phase(card, launches_k)
    channel_kernel = _channel_phase(card, launches_l)

    # ---- 7. kernel C vs plain: one whole CMA frame (10,000 symbols), R = 5
    # (rtol 1e-4 with an absolute floor of 1e-6 of each tensor's scale:
    # float32 sums in another order; CMA has no Adam to amplify them)
    Rc = CMA_RUNS
    rx_c = sim(gen, thetas[0], Rc)[0]
    h_c = dirac_taps_dp(M, dev) + 0.01 * torch.randn((Rc, 2, 2, 2, M), generator=rng, device=dev)
    lr_c = CMA_VARIANTS["CMA"][1]
    got = cma_dp_kernel(rx_c, cfg.R, h_c, lr_c, cfg.sps)
    again = cma_dp_kernel(rx_c, cfg.R, h_c, lr_c, cfg.sps)
    torch.cuda.synchronize()
    if not all(torch.equal(a_, b_) for a_, b_ in zip(got, again)):
        raise AssertionError("kernel C: two launches on the same inputs differ")
    want = cma_dp_plain(rx_c, cfg.R, h_c, lr_c, cfg.sps)
    errs_c: dict = {}
    for name, g_, w_ in zip(("out", "h", "e"), got, want):
        _check(name, g_, w_, 1e-4, 1e-6 * float(w_.abs().max()), errs_c)
    ms_c = _time_ms(lambda: cma_dp_kernel(rx_c, cfg.R, h_c, lr_c, cfg.sps))
    ms_c_launch = _launch_alone_ms(lambda: cma_dp_kernel(rx_c, cfg.R, h_c, lr_c, cfg.sps), "cma_dp_launch")
    # per symbol: the 2x2 butterfly output (4 x 4M multiply-adds), the CMA
    # error and the tap update (4 x 4M multiply-adds)
    n_sym_c = rx_c.shape[-1] // cfg.sps
    cma_flops = Rc * n_sym_c * (2 * 2 * 16 * M + 20)
    bound_c = _bound(cma_flops, _nbytes((rx_c, h_c), got))
    # the plain per-symbol loop is ~10^5 small launches: one timed frame
    ms_c_plain = _time_ms(lambda: cma_dp_plain(rx_c, cfg.R, h_c, lr_c, cfg.sps), reps=1, warmup=False)
    _line("7 kernel C", ok=True, R=Rc, errs_abs_rel=_fmt(errs_c), bit_identical=True,
          ms=f"{ms_c:.4f}", launch_ms=f"{ms_c_launch:.4f}", plain_ms=f"{ms_c_plain:.3f}",
          bound_ms=f"{bound_c['bound_ms']:.6f}",
          **_clocks_kv(cma_dp_clocks(rx_c, cfg.R, h_c, lr_c, cfg.sps)))

    # ---- 8. kernel D vs plain: one whole CMAbatch and CMAflex frame, R = 5
    d_res = {}
    for v, S in (("CMAbatch", cfg.batch_len), ("CMAflex", cfg.flex_step)):
        lr_v = CMA_VARIANTS[v][1]
        d_args = (rx_c, cfg.R, h_c, lr_v, cfg.batch_len, S, cfg.sps)
        got = cma_chunked_frame(*d_args)
        again = cma_chunked_frame(*d_args)
        torch.cuda.synchronize()
        if not all(torch.equal(a_, b_) for a_, b_ in zip(got, again)):
            raise AssertionError(f"kernel D {v}: two launches on the same inputs differ")
        want = cma_chunked_frame_plain(*d_args)
        errs_d: dict = {}
        for name, g_, w_ in zip(("out", "h", "e"), got, want):
            _check(name, g_, w_, 1e-4, 1e-6 * float(w_.abs().max()), errs_d)
        ms_d = _time_ms(lambda: cma_chunked_frame(*d_args))
        ms_d_launch = _launch_alone_ms(lambda: cma_chunked_frame(*d_args), "cma_chunked_launch")
        ms_d_plain = _time_ms(lambda: cma_chunked_frame_plain(*d_args), reps=1, warmup=False)
        n_full = chunk_schedule(n_sym_c, cfg.batch_len, S, M // 2, cfg.sps)[1]
        bound_d = _bound(Rc * _cma_chunked_flops(n_sym_c, M, cfg.batch_len, S, n_full),
                         _nbytes((rx_c, h_c), got))
        d_res[v] = (max(a for a, _ in errs_d.values()), ms_d, ms_d_plain, bound_d)
        _line(f"8 kernel D {v}", ok=True, R=Rc, B=cfg.batch_len, S=S, errs_abs_rel=_fmt(errs_d),
              bit_identical=True, ms=f"{ms_d:.4f}", launch_ms=f"{ms_d_launch:.4f}",
              plain_ms=f"{ms_d_plain:.3f}", bound_ms=f"{bound_d['bound_ms']:.6f}",
              **_clocks_kv(cma_chunked_clocks(*d_args)))

    # ---- 9. the CMA path: each variant's full experiment, counted
    cma_launches = {}
    n_cma = cfg.n_frame_max  # = the flagship frame, so `sim` serves both paths
    n_eval = n_cma - 2 * cfg.n_cut
    for v, (mode, lr_v, band) in CMA_VARIANTS.items():
        cfg_v = dataclasses.replace(cfg, loss_type=v, lr=lr_v)
        path_kernel = cma_dp_kernel if v == "CMA" else cma_chunked_frame
        res, wall_v = _counted(path_kernel, cfg.num_frames, lambda cfg_v=cfg_v, mode=mode:
                               train_dp.run_cma_dp(cfg_v, seed=0, device=DEVICE, runs=Rc,
                                                   use_pallas=mode),
                               also=_with_channel(cfg.num_frames))
        cma_launches[v] = cfg.num_frames
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
        wfn_v = MarginWeight(n_eval)

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

    awgn_kernels = _awgn_phases(card)
    nn_kernels = _nn_phases(card)
    stream_kernels = _stream_phases(card)
    launches_a = _step_path_phase(card, cfg, sim, gen, thetas, w0, h0, const, amps, var, P)
    flex_kernels = _vaeflex_phases(card, cfg, sim, gen, w0, h0, const, amps, var, P)
    per_run = _per_run_phase(card, cfg, sim, gen, w0, h0, const, amps, P, f_args)
    sweep_kernel = _sweep_phases(card, cfg, const, amps, var, w0, h0, per_run)
    cma_awgn_kernels = _cma_awgn_phases(card)
    dfe_kernels = _dfe_phases(card)
    _drivers_phase(card)
    _resume_phases(card)
    _graph_phases(card)
    _profiling_phase(card, f_args, ms_b)  # 33c, before any process group (its docstring)
    sp_loop = _seqpar_phases(card)
    _seqpar_option_phases(card, sp_loop)
    _run_sharding_phases(card, flagship, flagship_wall)

    kernels = {"kernels": [
        {"name": "vae_dp_loss_and_grad", "route": "cuda",
         "source": "vae_equalizer_tpu_torch/csrc/dp_kernels.cu",
         "replaces": "vae_equalizer_tpu/ops/elbo_kernel.py:361", "launches": launches_a,
         "max_abs_err": max(errs_a["gw"][0], errs_a["gh"][0]), "ms": ms_a, "plain_ms": ms_a_plain,
         **bound_a},
        {"name": "vae_dp_frame_train", "route": "cuda",
         "source": "vae_equalizer_tpu_torch/csrc/dp_kernels.cu",
         "replaces": "vae_equalizer_tpu/ops/frame_kernel.py:1024", "launches": launches_b,
         "max_abs_err": b_err, "ms": ms_b, "plain_ms": ms_b_plain, **bound_b},
        {"name": "cma_dp_kernel", "route": "cuda",
         "source": "vae_equalizer_tpu_torch/csrc/cma_kernels.cu",
         "replaces": "vae_equalizer_tpu/ops/cma_kernel.py:128", "launches": cma_launches["CMA"],
         "max_abs_err": max(a for a, _ in errs_c.values()), "ms": ms_c, "plain_ms": ms_c_plain,
         **bound_c},
    ] + [
        {"name": f"cma_chunked_frame[{v}]", "route": "cuda",
         "source": "vae_equalizer_tpu_torch/csrc/cma_kernels.cu",
         "replaces": "vae_equalizer_tpu/ops/cma_frame_kernel.py:404", "launches": cma_launches[v],
         "max_abs_err": d_res[v][0], "ms": d_res[v][1], "plain_ms": d_res[v][2], **d_res[v][3]}
        for v in ("CMAbatch", "CMAflex")
    ] + [eval_kernel, channel_kernel] + flex_kernels + [sweep_kernel] + awgn_kernels + nn_kernels + stream_kernels
        + cma_awgn_kernels + dfe_kernels}
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
