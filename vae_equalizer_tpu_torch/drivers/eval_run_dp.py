"""Optical DP sweep driver — the reference's Eval_run_DP.py (port of
``vae_equalizer_tpu/drivers/eval_run_dp.py``).

Grid axes, defaults, refusals and the saved .mat layout are the JAX
driver's (Eval_run_DP.py:18-114): the algorithm is selected with
--loss-type, and the iter repeats of a grid point run as the runs axis of
one experiment on the card. With ``--pallas-frame --batch-lr-axis`` (or
``--batch-snr-axis`` / ``--batch-nu-axis``) the points of that axis run
too as runs of one experiment: one kernel B launch per frame for the whole
grid. ``--compiled`` runs each experiment as one CUDA graph of a frame,
replayed over every frame; ``--frames-per-call K`` replays it K frames per
chunk (both give the loop mode's results bit for bit, ``train/harness.py``).
``--sp S`` runs the dp x sp sharded runners (``parallel/seqpar.py``): on the
card S must divide the card count and the runs go over dp = cards / S
(JAX's rule); with ``--device cpu`` dp is 1 and S gloo ranks run on the CPU.
With ``--sp``, ``--compiled`` and ``--frames-per-call K`` keep their copies
and progress without a CUDA graph (the ranks' collectives pass through the
host), and ``--checkpoint-every K`` saves every run's state to rank 0's
file; each gives the results of ``--sp`` alone bit for bit.

    python -m vae_equalizer_tpu_torch.drivers.eval_run_dp --pallas-frame --batch-snr-axis \\
        --snr 16 17 18 19 20 21 22 23 --lr 2.5e-3
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import make_mesh_2d
from ..parallel.sweep import assemble_mat, run_sweep
from ..train.modes import PALLAS_MODES
from ..utils.config import DpConfig
from ._common import base_parser, make_progress, save_results, setup, sweep_resume_kwargs


def main(argv=None):
    """Run the sweep; returns the path of the saved .mat."""
    p = base_parser("Optical dual-pol sweep (VAE/VAEflex/CMA/CMAbatch/CMAflex)")
    p.add_argument("--loss-type", default="VAE",
                   choices=["VAE", "VAEflex", "CMA", "CMAbatch", "CMAflex"])
    p.add_argument("--mod", default="64-QAM")
    p.add_argument("--snr", type=float, nargs="+", default=[23.0])
    p.add_argument("--nu", type=float, nargs="+", default=[0.0])
    p.add_argument("--lr", type=float, nargs="+", default=[2.5e-3, 2e-3, 3e-3])
    p.add_argument("--M", type=int, nargs="+", default=[25])
    p.add_argument("--batch-len", type=int, nargs="+", default=[100])
    p.add_argument("--flex-step", type=int, nargs="+", default=[10])
    p.add_argument("--theta-diff", type=float, nargs="+", default=[0.06 * np.pi])
    p.add_argument("--symb-rate", type=float, nargs="+", default=[90e9])
    p.add_argument("--num-frames", type=int, default=170)
    p.add_argument("--n-frame-max", type=int, default=10000)
    p.add_argument("--pallas", action="store_true",
                   help="per-step kernel: one launch per minibatch for all runs (VAE/VAEflex "
                        "kernel A, CMA kernel C; sps=2, odd M)")
    p.add_argument("--pallas-frame", action="store_true",
                   help="whole-frame kernel: all minibatch steps + Adam in one launch per frame "
                        "for all runs (VAE/VAEflex kernel B, CMAbatch/CMAflex kernel D; sps=2, "
                        "odd M)")
    p.add_argument("--runs-batch", type=int, default=None, metavar="B",
                   help="runs per kernel launch (with --pallas-frame; VAE/VAEflex/CMAbatch/"
                        "CMAflex; default: all runs in one launch)")
    p.add_argument("--batch-lr-axis", action="store_true",
                   help="run each lr-axis group of grid points as ONE call, per-run lr in the "
                        "frame kernel (VAE/VAEflex with --pallas-frame); one JSONL record per "
                        "point as usual")
    p.add_argument("--batch-snr-axis", action="store_true",
                   help="like --batch-lr-axis for the SNR axis: per-run channel noise and "
                        "demapper variance")
    p.add_argument("--batch-nu-axis", action="store_true",
                   help="like --batch-lr-axis for the shaping parameter nu: per-run sampling "
                        "pmf, demapper and prior constants")
    p.add_argument("--stream-bf16", action="store_true",
                   help="store the frame kernel's out / dec / eq streams as bfloat16 (with "
                        "--pallas-frame + runs); mm / s1 stay float32")
    p.add_argument("--frames-per-call", type=int, default=1, metavar="K",
                   help="K frames per call: a frame's CUDA graph replayed K times (with --sp "
                        "the step called K times), one device-to-host copy and per-frame "
                        "progress per chunk")
    p.add_argument("--sp", type=int, default=1, metavar="S",
                   help="sequence-parallel degree: each minibatch's samples split over S ranks "
                        "(VAE/VAEflex, autograd). On the card S must divide the card count, "
                        "dp = cards / S, iters rounded up to a multiple of dp; with --device cpu "
                        "dp = 1 and S gloo ranks run on the CPU")
    args = p.parse_args(argv)
    if args.pallas and args.pallas_frame:
        p.error("--pallas and --pallas-frame are mutually exclusive")
    if args.runs_batch and not args.pallas_frame:
        p.error("--runs-batch needs --pallas-frame")
    if (args.batch_lr_axis or args.batch_snr_axis or args.batch_nu_axis) and (
            not args.pallas_frame or args.loss_type not in ("VAE", "VAEflex")):
        p.error("--batch-lr-axis/--batch-snr-axis/--batch-nu-axis need "
                "--pallas-frame and --loss-type VAE or VAEflex")
    if args.stream_bf16 and not args.pallas_frame:
        p.error("--stream-bf16 needs --pallas-frame")
    # kernel-path support comes from the runners' own table, so the CLI can
    # never accept a combination the runner would reject (train/modes.py)
    if args.pallas_frame and "frame" not in PALLAS_MODES[args.loss_type]:
        p.error(f"--pallas-frame supports "
                f"{'/'.join(k for k, v in PALLAS_MODES.items() if 'frame' in v)}, "
                f"not {args.loss_type}")
    if args.pallas_frame and args.loss_type == "VAEflex" and any(
            b % f for b in args.batch_len for f in args.flex_step):
        p.error("--pallas-frame (VAEflex) needs batch-len divisible by "
                "flex-step (windows assemble from reshaped chunks)")
    if args.pallas and True not in PALLAS_MODES[args.loss_type]:
        p.error(f"--pallas supports "
                f"{'/'.join(k for k, v in PALLAS_MODES.items() if True in v)}, "
                f"not {args.loss_type}")
    if args.sp > 1:
        if args.loss_type not in ("VAE", "VAEflex"):
            p.error("--sp requires --loss-type VAE or VAEflex")
        if args.pallas or args.pallas_frame:
            p.error("--sp and --pallas/--pallas-frame are mutually exclusive "
                    "(the sharded step has no fused-kernel path)")
        if args.loss_type == "VAEflex" and any(b % f for b in args.batch_len for f in args.flex_step):
            p.error("--sp (VAEflex) needs batch-len divisible by flex-step")

    iters = args.iters or 5
    if args.quick:
        args.mod, args.snr, args.lr = "4-QAM", [20.0], [args.lr[0]]
        args.num_frames, args.n_frame_max, iters = 4, 2000, args.iters or 2

    base = DpConfig(loss_type=args.loss_type, mod=args.mod, num_frames=args.num_frames,
                    n_frame_max=args.n_frame_max, n_lrhalf=170)
    axes = dict(snr_db=args.snr, symb_rate=args.symb_rate, nu=args.nu, theta_diff=args.theta_diff,
                m_est=args.M, lr=args.lr, batch_len=args.batch_len, flex_step=args.flex_step)
    device, seed, mesh = setup(args)
    runner_name = args.loss_type
    if args.sp > 1:
        if device.type == "cuda":
            n_dev = torch.cuda.device_count()
            if n_dev % args.sp != 0:
                p.error(f"--sp {args.sp} must divide the device count ({n_dev})")
            mesh = make_mesh_2d(n_dev // args.sp, args.sp)
        else:
            mesh = make_mesh_2d(1, args.sp, devices=device)
        runner_name = f"{args.loss_type}-SP"
        if iters % mesh.n_dp:
            iters = (iters // mesh.n_dp + 1) * mesh.n_dp
            print(f"# --sp: rounding iters up to {iters} (multiple of dp={mesh.n_dp})")
    results, axes_values, jsonl = run_sweep(
        runner_name, base, axes, iters, seed, mesh=mesh, out_dir=args.out,
        tag=f"{args.loss_type}_DP_{args.mod}", progress=make_progress(args.verbose),
        batch_lr_axis=args.batch_lr_axis, batch_snr_axis=args.batch_snr_axis,
        batch_nu_axis=args.batch_nu_axis, device=device, compiled=args.compiled,
        **sweep_resume_kwargs(args),
        runner_kwargs={
            **({"use_pallas": True} if args.pallas else {}),
            **({"use_pallas": "frame"} if args.pallas_frame else {}),
            **({"runs_batch": args.runs_batch} if args.runs_batch else {}),
            **({"stream_bf16": True} if args.stream_bf16 else {}),
            **({"chunk_frames": args.frames_per_call} if args.frames_per_call > 1 else {}),
        } or None,
    )
    ser = assemble_mat(results, axes_values, iters, (4,))
    # per-frame noise-variance estimate + the true per-pol variance, in the
    # reference's archive layout (Eval_run_DP.py:53-54, 99-101: Var_est
    # (2, grid, iter, frames), var_real (2, grid, iter, 1))
    var_est = assemble_mat(results, axes_values, iters, (2,), key="var_est")
    var_real = assemble_mat(results, axes_values, iters, (2,), key="var")
    name = save_results(args.out, f"{args.loss_type}_DP_{args.mod}_N_lrhalf_170_N_train_{args.n_frame_max}", {
        "SER": ser,
        **({"Var_est": var_est} if var_est is not None else {}),
        **({"var_real": var_real} if var_real is not None else {}),
        "SNR": args.snr,
        "nu": args.nu,
        "theta_diff": args.theta_diff,
        "theta": [base.theta],
        "M": args.M,
        "lr": args.lr,
        "batch_len": args.batch_len,
        "symb_rate": args.symb_rate,
        "symb_step": args.flex_step,
    })
    print(f"{len(results)} grid points -> {jsonl}")
    return name


if __name__ == "__main__":
    main()
