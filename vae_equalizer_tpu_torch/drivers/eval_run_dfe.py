"""LMMSE / DFE SNR-sweep driver — the reference's DFE_MQAM_shaping.py main part
(port of ``vae_equalizer_tpu/drivers/eval_run_dfe.py``).

The CLI, defaults, ``--quick`` workload, JSONL and .mat names and the
per-SNR printout are the JAX driver's; every frame's decision loop runs in
one kernel J launch on the card.

    python -m vae_equalizer_tpu_torch.drivers.eval_run_dfe --quick --device cpu
"""

from __future__ import annotations

from ..train.dfe import run_lmmse_dfe
from ..utils import io
from ..utils.config import LmmseDfeConfig
from ._common import base_parser, save_results, setup


def main(argv=None):
    """Run the sweep; returns the path of the saved .mat."""
    p = base_parser("LMMSE + DFE known-channel baseline over an SNR sweep")
    p.add_argument("--mod", default="64-QAM")
    p.add_argument("--channel", default="h1")
    p.add_argument("--nu", type=float, default=0.0270955)
    p.add_argument("--snr", type=float, nargs="+", default=list(range(15, 23)))
    p.add_argument("--n-valid", type=int, default=128000)
    p.add_argument("--num-epochs", type=int, default=5)
    args = p.parse_args(argv)

    if args.quick:
        args.snr, args.n_valid, args.num_epochs = [18.0, 22.0], 16000, 2

    cfg = LmmseDfeConfig(mod=args.mod, channel=args.channel, nu=args.nu, n_valid=args.n_valid,
                         num_epochs=args.num_epochs)
    device, seed, _ = setup(args)  # the LMMSE / DFE sweep has no runs mesh, as in JAX
    res = run_lmmse_dfe(
        cfg, seed, device=device, snrs=tuple(args.snr),
        progress=(lambda e, m: print(" ", m, flush=True)) if args.verbose else None,
    )
    io.append_jsonl(f"{args.out}/lmmse_dfe.jsonl", {"config": cfg, **res})
    name = save_results(args.out, f"LMMSE_DFE_{args.channel}_{args.mod}", {
        "SER_mmse": res["ser_mmse"], "SER_dfe": res["ser_dfe"], "SNR": res["snrs"],
    })
    for i, snr in enumerate(res["snrs"]):
        print(f"SNR {snr}: SER_mmse={res['ser_mmse'][i].mean():.5f} "
              f"SER_dfe={res['ser_dfe'][i].mean():.5f}")
    return name


if __name__ == "__main__":
    main()
