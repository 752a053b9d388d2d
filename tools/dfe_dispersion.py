"""Dispersion of the LMMSE / DFE sweep's SER, behind chip_smoke.py's phase 28 gate.

    PYTHONPATH=. python tools/dfe_dispersion.py --port-seeds 10 --jax-keys 3 [--workers 3]

Runs ``run_lmmse_dfe(LmmseDfeConfig())`` (8 SNRs x 5 epochs x 128,000
symbols) of the port on the CPU at seeds 0 .. n-1 and of the JAX package on
the CPU at keys 0 .. k-1, each sweep in its own process (about 20-40 s a
port sweep, 2 min a JAX sweep, ~4 GB each), and prints one JSON line per
sweep (the per-epoch SERs), then per SNR and equalizer: the pooled
per-epoch variance over the binomial p (1 - p) / 128,000 ("D"), the two
packages' means, and for every sweep the worst |mean - JAX's table| over
chip_smoke.py's tolerance 3 sqrt(D_gate 2 p (1 - p) / 640,000) at D_gate 1
and chip_smoke.DFE_DISPERSION.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp

import numpy as np


def _sweep(job):
    kind, seed = job
    if kind == "port":
        import torch

        torch.set_num_threads(1)
        from vae_equalizer_tpu_torch.train.dfe import run_lmmse_dfe
        from vae_equalizer_tpu_torch.utils import LmmseDfeConfig

        r = run_lmmse_dfe(LmmseDfeConfig(), seed, device="cpu")
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")
        from vae_equalizer_tpu.train.dfe import run_lmmse_dfe
        from vae_equalizer_tpu.utils.config import LmmseDfeConfig

        r = run_lmmse_dfe(LmmseDfeConfig(), jax.random.PRNGKey(seed))
    return {"kind": kind, "seed": seed, "mmse": np.asarray(r["ser_mmse"]).tolist(),
            "dfe": np.asarray(r["ser_dfe"]).tolist()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port-seeds", type=int, default=10)
    ap.add_argument("--jax-keys", type=int, default=3)
    ap.add_argument("--workers", type=int, default=3)
    a = ap.parse_args()
    import chip_smoke

    jobs = [("port", s) for s in range(a.port_seeds)] + [("jax", k) for k in range(a.jax_keys)]
    with mp.get_context("spawn").Pool(a.workers, maxtasksperchild=1) as pool:
        sweeps = []
        for res in pool.imap_unordered(_sweep, jobs):
            print(json.dumps(res), flush=True)
            sweeps.append(res)
    n_sym = 128000  # LmmseDfeConfig().n_valid
    snrs = sorted(chip_smoke.DFE_JAX_SER)
    worst = {1.0: 0.0, chip_smoke.DFE_DISPERSION: 0.0}
    for j, eq in enumerate(("mmse", "dfe")):
        for i, snr in enumerate(snrs):
            per = np.array([s[eq][i] for s in sweeps])  # (sweeps, epochs)
            p = float(per.mean())
            var = float(((per - per.mean(1, keepdims=True)) ** 2).sum() / (per.size - len(per)))
            means = {k: float(np.mean([np.mean(s[eq][i]) for s in sweeps if s["kind"] == k]))
                     for k in ("port", "jax") if any(s["kind"] == k for s in sweeps)}
            p_ref = chip_smoke.DFE_JAX_SER[snr][j]
            for d in worst:
                tol = 3 * np.sqrt(d * 2 * p_ref * (1 - p_ref) / (5 * n_sym))
                worst[d] = max(worst[d], max(abs(np.mean(s[eq][i]) - p_ref) / tol for s in sweeps))
            print(json.dumps({"snr": snr, "eq": eq, "D": var / (p * (1 - p) / n_sym),
                              "means": means, "jax_table": p_ref}), flush=True)
    print(json.dumps({"worst_over_tolerance": {str(d): w for d, w in worst.items()},
                      "sweeps": len(sweeps)}), flush=True)


if __name__ == "__main__":
    main()
