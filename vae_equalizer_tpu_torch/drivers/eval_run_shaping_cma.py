"""AWGN CMA sweep driver — the reference's Eval_run_shaping_cma.py (port of
``vae_equalizer_tpu/drivers/eval_run_shaping_cma.py``).

The CLI, defaults, ``--quick`` workload and saved .mat layout are the JAX
driver's; the iter repeats of a grid point run as the runs axis of one
``run_cma_awgn`` call (one kernel I launch on the card).

    python -m vae_equalizer_tpu_torch.drivers.eval_run_shaping_cma --quick --device cpu
"""

from __future__ import annotations

from ..parallel.sweep import assemble_mat, run_sweep
from ..utils.config import AwgnCmaConfig
from ._common import base_parser, make_progress, save_results, setup, sweep_resume_kwargs


def main(argv=None):
    """Run the sweep; returns the path of the saved .mat."""
    p = base_parser("AWGN CMA baseline sweep")
    p.add_argument("--mod", default="64-QAM")
    p.add_argument("--channel", default="h1")
    p.add_argument("--snr", type=float, nargs="+", default=[22.0])
    p.add_argument("--nu", type=float, nargs="+", default=[0.0])
    p.add_argument("--lr", type=float, nargs="+", default=[0.5e-4])
    p.add_argument("--M", type=int, nargs="+", default=[25])
    p.add_argument("--num-epochs", type=int, default=500)
    p.add_argument("--n-train", type=int, default=4000)
    p.add_argument("--n-valid", type=int, default=15000)
    args = p.parse_args(argv)

    iters = args.iters or 3
    if args.quick:
        args.mod, args.snr, args.lr = "4-QAM", [18.0], [1e-3]
        args.num_epochs, args.n_valid, iters = 30, 4000, args.iters or 2

    base = AwgnCmaConfig(mod=args.mod, channel=args.channel, num_epochs=args.num_epochs,
                         n_train=args.n_train, n_valid=args.n_valid)
    axes = dict(snr_db=args.snr, nu=args.nu, m_est=args.M, lr=args.lr)
    device, seed = setup(args)
    results, axes_values, jsonl = run_sweep(
        "CMA-AWGN", base, axes, iters, seed, out_dir=args.out, tag=f"CMA_shaping_{args.mod}",
        progress=make_progress(args.verbose), compiled=args.compiled, device=device,
        **sweep_resume_kwargs(args))
    ser = assemble_mat(results, axes_values, iters, ())
    name = save_results(args.out, f"CMA_shaping_{args.nu[0]}_{args.channel}_{args.mod}", {
        "SER": ser, "SNR": args.snr, "M": args.M, "lr": args.lr, "nu": args.nu,
    })
    print(f"{len(results)} grid points -> {jsonl}")
    return name


if __name__ == "__main__":
    main()
