"""AWGN VAE-LE sweep driver — the reference's Eval_run_shaping_vaele.py (port of
``vae_equalizer_tpu/drivers/eval_run_shaping_vaele.py``).

The CLI, defaults, refusals, ``--quick`` workload and saved .mat layout are
the JAX driver's; the iter repeats of a grid point run as the runs axis of
one ``train_vae_le_awgn`` call. ``--pallas`` launches kernel F once per
minibatch for all runs, ``--pallas-frame`` kernel G once per experiment (or
once per group of ``--runs-batch``); without either the runner trains by
autograd.

    python -m vae_equalizer_tpu_torch.drivers.eval_run_shaping_vaele --pallas-frame
"""

from __future__ import annotations

from ..parallel.sweep import assemble_mat, run_sweep
from ..utils.config import AwgnVaeLeConfig
from ._common import base_parser, make_progress, save_results, setup, sweep_resume_kwargs


def main(argv=None):
    """Run the sweep; returns the path of the saved .mat."""
    p = base_parser("AWGN VAE-LE sweep (PCS shaping)")
    p.add_argument("--mod", default="64-QAM")
    p.add_argument("--channel", default="h1")
    p.add_argument("--snr", type=float, nargs="+", default=[24.0])
    p.add_argument("--nu", type=float, nargs="+", default=[0.0])
    p.add_argument("--lr", type=float, nargs="+", default=[5e-3])
    p.add_argument("--M", type=int, nargs="+", default=[25])
    p.add_argument("--batch-len", type=int, nargs="+", default=[350])
    p.add_argument("--num-epochs", type=int, default=500)
    p.add_argument("--n-train", type=int, default=1200)
    p.add_argument("--n-valid", type=int, default=15000)
    p.add_argument("--pallas", action="store_true",
                   help="per-step kernel F: one launch per minibatch for all runs (sps=2, odd M)")
    p.add_argument("--pallas-frame", action="store_true",
                   help="whole-experiment kernel G: every epoch's steps + AMSGrad in one launch, "
                        "evals batched (ops/siso_frame_kernel.py; sps=2, odd M)")
    p.add_argument("--runs-batch", type=int, default=None,
                   help="with --pallas-frame: runs per kernel G launch (default: all runs in one "
                        "launch)")
    args = p.parse_args(argv)
    if args.pallas and args.pallas_frame:
        p.error("--pallas and --pallas-frame are mutually exclusive")

    iters = args.iters or 20
    if args.quick:
        args.mod, args.snr = "4-QAM", [18.0]
        args.num_epochs, args.n_valid, iters = 30, 4000, args.iters or 2

    base = AwgnVaeLeConfig(mod=args.mod, channel=args.channel, num_epochs=args.num_epochs,
                           n_train=args.n_train, n_valid=args.n_valid)
    axes = dict(snr_db=args.snr, nu=args.nu, m_est=args.M, lr=args.lr, batch_len=args.batch_len)
    device, seed, mesh = setup(args)
    results, axes_values, jsonl = run_sweep(
        "VAE-LE-AWGN", base, axes, iters, seed, mesh=mesh, out_dir=args.out,
        tag=f"VAELE_shaping_{args.mod}",
        progress=make_progress(args.verbose), compiled=args.compiled, device=device,
        **sweep_resume_kwargs(args),
        runner_kwargs={"use_pallas": True} if args.pallas
        else {"use_pallas": "frame",
              **({"runs_batch": args.runs_batch} if args.runs_batch else {})}
        if args.pallas_frame else None,
    )
    ser = assemble_mat(results, axes_values, iters, ())
    name = save_results(args.out, f"VAELE_shaping_{args.nu[0]}_{args.channel}_{args.mod}", {
        "SER": ser, "SNR": args.snr, "M": args.M, "lr": args.lr,
        "N_train": args.batch_len, "nu": args.nu,
    })
    print(f"{len(results)} grid points -> {jsonl}")
    return name


if __name__ == "__main__":
    main()
