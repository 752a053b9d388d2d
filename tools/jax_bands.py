"""Reference numbers of the JAX package on the CPU, for the port's accuracy bands.

Runs one experiment of the JAX package and prints one JSON line:

  PYTHONPATH=. python tools/jax_bands.py nn --key 0 --runs 4 [--bn]
      train_vae_nn_awgn(AwgnVaeNnConfig(batchnorm=...), compiled=True): per
      run the mean SER of the last 25 evals and the final MI. The JAX
      package's runs axis cannot carry Net_BN's state (its float momentum),
      so with --bn the runs are keys key, key + 1, ... each with runs=None.
  PYTHONPATH=. python tools/jax_bands.py vaeflex --key 0 --runs 2
      train_vae_flex_dp(DpConfig(), compiled=True) (64-QAM, 23 dB, 170 frames
      of 10,000 symbols, windows of 100 every 10): per run the last-20-frame
      mean soft SER (both pols) and the final MI (mean of the pols).
  PYTHONPATH=. python tools/jax_bands.py stream --key 0 --blocks 200 [--mod 64-QAM]
      the DP channel of DpConfig() (23 dB, h0, CD/PMD, theta = pi/10) as one
      continuous stream through StreamingReceiver(adapt=True): the SER of
      every 2,000-symbol block (find_shift_dp -> roll_dp -> ser_iqflip).
  PYTHONPATH=. python tools/jax_bands.py cma_awgn --key 0 --runs 2
      run_cma_awgn(AwgnCmaConfig(), compiled=True) (64-QAM, h1, 22 dB, 500
      epochs of 4,000 symbols, 250 evals): per run the mean SER of the last 25
      evals and the final MI.

JAX is pinned to the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def run_nn(key: int, runs: int, bn: bool) -> dict:
    from vae_equalizer_tpu.train.awgn import train_vae_nn_awgn
    from vae_equalizer_tpu.utils.config import AwgnVaeNnConfig

    cfg = AwgnVaeNnConfig(batchnorm=bn)
    if bn:
        res = [train_vae_nn_awgn(cfg, jax.random.PRNGKey(key + i), compiled=True)
               for i in range(runs)]
        ser = np.stack([np.asarray(r["ser"]) for r in res])
        mi = np.stack([np.asarray(r["mi"]) for r in res])
    else:
        r = train_vae_nn_awgn(cfg, jax.random.PRNGKey(key), runs=runs, compiled=True)
        ser, mi = np.asarray(r["ser"]), np.asarray(r["mi"])
    return {"ser_last25": ser[:, -25:].mean(-1).tolist(), "mi_final": mi[:, -1].tolist()}


def run_vaeflex(key: int, runs: int) -> dict:
    from vae_equalizer_tpu.train.dp import train_vae_flex_dp
    from vae_equalizer_tpu.utils.config import DpConfig

    r = train_vae_flex_dp(DpConfig(), jax.random.PRNGKey(key), runs=runs, compiled=True)
    ser, mi = np.asarray(r["ser"]), np.asarray(r["mi"])  # (runs, 4, F), (runs, 2, F)
    return {"soft_ser_last20": ser[:, 2:, -20:].mean((-2, -1)).tolist(),
            "const_ser_last20": ser[:, :2, -20:].mean((-2, -1)).tolist(),
            "mi_final": mi[:, :, -1].mean(-1).tolist()}


def run_cma_awgn(key: int, runs: int) -> dict:
    from vae_equalizer_tpu.train.awgn import run_cma_awgn
    from vae_equalizer_tpu.utils.config import AwgnCmaConfig

    r = run_cma_awgn(AwgnCmaConfig(), jax.random.PRNGKey(key), runs=runs, compiled=True)
    ser, mi = np.asarray(r["ser"]), np.asarray(r["mi"])  # (runs, n_evals)
    return {"ser_last25": ser[:, -25:].mean(-1).tolist(), "mi_final": mi[:, -1].tolist()}


def run_stream(key: int, blocks: int, mod: str, block: int = 2000) -> dict:
    from vae_equalizer_tpu.channels import channel_ir, make_dp_simulator
    from vae_equalizer_tpu.core import make_constellation
    from vae_equalizer_tpu.core.constellation import demapper_noise_var
    from vae_equalizer_tpu.metrics import find_shift_dp, ser_iqflip
    from vae_equalizer_tpu.models.streaming import StreamingReceiver
    from vae_equalizer_tpu.train.eval_utils import margin_weight_maxshift, roll_dp
    from vae_equalizer_tpu.utils.config import DpConfig

    cfg = DpConfig(mod=mod)
    const = make_constellation(cfg.mod, cfg.nu)
    h_up, _ = channel_ir(cfg.channel, cfg.sps)
    n_total = blocks * block
    gen = jax.jit(make_dp_simulator(const, cfg.snr_db, h_up, n_total, cfg.sps, cfg.symb_rate,
                                    cfg.tau_cd, cfg.tau_pmd, np.asarray(cfg.phi_iq)))
    rx, tx, _ = gen(jax.random.PRNGKey(key), jnp.float32(cfg.theta))
    amps = jnp.asarray(const.amps)
    rxr = StreamingReceiver(amps=amps, P=jnp.asarray(const.P, jnp.float32),
                            var=jnp.full((2,), demapper_noise_var(const, cfg.snr_db), jnp.float32),
                            nu_sc=const.nu_sc, m_est=cfg.m_est, sps=cfg.sps, block_len=block,
                            lr=cfg.lr, adapt=True)
    state = rxr.init()
    sers = []
    for b in range(blocks):
        state, q, _ = rxr.step(state, rx[:, :, b * block * cfg.sps : (b + 1) * block * cfg.sps])
        txb = tx[:, :, b * block : (b + 1) * block]
        shift, r = find_shift_dp(q, txb, 21, amps)
        w = margin_weight_maxshift(block, jnp.max(jnp.abs(shift)))
        sers.append(float(np.mean(np.asarray(ser_iqflip(roll_dp(q, shift, r), txb, weight=w)))))
    return {"mod": mod, "block": block, "ser_blocks": sers}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("cma_awgn", "nn", "stream", "vaeflex"))
    ap.add_argument("--key", type=int, default=0)
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--bn", action="store_true")
    ap.add_argument("--blocks", type=int, default=200)
    ap.add_argument("--mod", default="64-QAM")
    a = ap.parse_args()
    t0 = time.perf_counter()
    if a.what == "nn":
        out = {"what": "nn_bn" if a.bn else "nn", "key": a.key, "runs": a.runs,
               **run_nn(a.key, a.runs, a.bn)}
    elif a.what == "cma_awgn":
        out = {"what": "cma_awgn", "key": a.key, "runs": a.runs, **run_cma_awgn(a.key, a.runs)}
    elif a.what == "vaeflex":
        out = {"what": "vaeflex", "key": a.key, "runs": a.runs, **run_vaeflex(a.key, a.runs)}
    else:
        out = {"what": "stream", "key": a.key, **run_stream(a.key, a.blocks, a.mod)}
    out["seconds"] = time.perf_counter() - t0
    out["jax"] = jax.__version__
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
