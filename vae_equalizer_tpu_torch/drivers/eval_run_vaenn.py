"""AWGN VAE-NN sweep driver — the reference's Eval_run_vaenn.py (port of
``vae_equalizer_tpu/drivers/eval_run_vaenn.py``).

The CLI, defaults, ``--quick`` workload and saved .mat layout are the JAX
driver's; the iter repeats of a grid point run as the runs axis of one
``train_vae_nn_awgn`` call. ``--pallas-frame`` launches kernel H once per
experiment for all runs; without it the runner trains through H's plain
engine.

    python -m vae_equalizer_tpu_torch.drivers.eval_run_vaenn --pallas-frame --net-type Net_BN
"""

from __future__ import annotations

from ..parallel.sweep import assemble_mat, run_sweep
from ..utils.config import AwgnVaeNnConfig
from ._common import base_parser, make_progress, save_results, setup, sweep_resume_kwargs


def main(argv=None):
    """Run the sweep; returns the path of the saved .mat."""
    p = base_parser("AWGN VAE-NN (CNN) sweep")
    p.add_argument("--mod", default="64-QAM")
    p.add_argument("--channel", default="h1")
    p.add_argument("--net-type", default="Net", choices=["Net", "Net_BN"])
    p.add_argument("--snr", type=float, nargs="+", default=[24.0])
    p.add_argument("--lr", type=float, nargs="+", default=[4e-3])
    p.add_argument("--M", type=int, nargs="+", default=[25])
    p.add_argument("--k1", type=int, nargs="+", default=[25])
    p.add_argument("--k2", type=int, nargs="+", default=[3])
    p.add_argument("--batch-len", type=int, nargs="+", default=[300])
    p.add_argument("--num-epochs", type=int, default=500)
    p.add_argument("--n-train", type=int, default=4000)
    p.add_argument("--n-valid", type=int, default=15000)
    p.add_argument("--pallas-frame", action="store_true",
                   help="whole-experiment kernel H: every epoch's steps + AMSGrad in one launch, "
                        "evals batched (ops/nn_frame_kernel.py; Net and Net_BN, sps=2, odd M, "
                        "k2=3)")
    args = p.parse_args(argv)

    iters = args.iters or 3
    if args.quick:
        args.mod, args.snr = "4-QAM", [18.0]
        args.num_epochs, args.n_valid, args.n_train, iters = 20, 4000, 2000, args.iters or 2

    base = AwgnVaeNnConfig(mod=args.mod, channel=args.channel, num_epochs=args.num_epochs,
                           n_train=args.n_train, n_valid=args.n_valid,
                           batchnorm=args.net_type == "Net_BN")
    axes = dict(snr_db=args.snr, kernel_1=args.k1, kernel_2=args.k2, m_est=args.M, lr=args.lr,
                batch_len=args.batch_len)
    device, seed = setup(args)
    results, axes_values, jsonl = run_sweep(
        "VAE-NN-AWGN", base, axes, iters, seed, out_dir=args.out, tag=f"{args.net_type}_{args.mod}",
        progress=make_progress(args.verbose), compiled=args.compiled, device=device,
        **sweep_resume_kwargs(args),
        runner_kwargs={"use_pallas": "frame"} if args.pallas_frame else None,
    )
    ser = assemble_mat(results, axes_values, iters, ())
    name = save_results(args.out, f"{args.net_type}_{args.channel}_{args.mod}", {
        "SER": ser, "SNR": args.snr, "k2": args.k2, "k1": args.k1,
        "M": args.M, "lr": args.lr, "N_train": args.batch_len,
    })
    print(f"{len(results)} grid points -> {jsonl}")
    return name


if __name__ == "__main__":
    main()
