"""Plain PyTorch reference of a batched SNR sweep of the DP VAE: the grid
points of an SNR axis batched as the runs of one experiment, each run at its
own point's SNR.

It imports neither the program (``vae_equalizer_tpu_torch``) nor JAX. It
takes the channel, the equalizer, the training step and the evaluation from
``benchmark/reference/dp_vae.py`` (float32, TF32 off unless ``prec`` asks
for the control, "tf32"), and adds what a sweep changes:

* the group's seed, from the sweep's seed and the group's first point, by
  the sweep engine's formula (``np.random.SeedSequence([seed, i])``);
* frame 0 of every run drawn in one pass for all runs (levels, then noise,
  from one ``torch.Generator``, as the runner draws them), with each run's
  noise scaled to its own point's SNR;
* each run trained with its own point's demapper variance
  pow_mean / 10^(SNR / 10) / 2, and each point evaluated with its own;
* each point's final butterflies evaluated on a fresh frame at that point's
  SNR.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from . import dp_vae as ref

__all__ = ["final_ser", "frame0", "group_seed", "point_var", "runs_snr"]


def group_seed(seed: int, i: int) -> int:
    """The seed of the runner call whose first grid point is point ``i`` of a
    sweep seeded with ``seed``."""
    return int(np.random.SeedSequence([seed, i]).generate_state(1)[0])


def runs_snr(snrs, iters: int) -> np.ndarray:
    """Each run's SNR (dB, float32): the points in grid order, ``iters`` runs each."""
    return np.repeat(np.asarray(snrs, np.float32), iters)


def point_var(st: ref.Setup, snr_db: float) -> np.float32:
    """A point's demapper variance, folded in float64 and rounded to float32."""
    return np.float32(st.pow_mean / 10.0 ** (np.float64(np.float32(snr_db)) / 10.0) / 2.0)


def _physics(st: ref.Setup, theta: float, levels, noise, snr_run: np.ndarray):
    """``Setup.physics`` with each run's noise at its own SNR: (rx, tx)."""
    sig = st.clean(theta, levels)
    p = torch.mean(sig**2, dim=(1, 2, 3), dtype=torch.float64).to(torch.float32)
    snr_lin = torch.from_numpy((10.0 ** (np.float64(snr_run) / 10.0)).astype(np.float32))
    sigma = torch.sqrt(p * 2 * st.cfg["sps"] / 2 / snr_lin.to(sig.device))
    sig = sig + sigma[:, None, None, None] * noise
    rx = sig[..., : st.cfg["sps"] * st.N].contiguous()
    tx = levels[:, :, st.offset : st.offset + st.N].reshape(-1, 2, 2, st.N)
    return rx, tx


def _with_var(st: ref.Setup, var: torch.Tensor) -> ref.Setup:
    """``st`` with the demapper variance ``var``, (2,) or per run (R, 2)."""
    out = copy.copy(st)
    out.var = var
    return out


def frame0(cfg: dict, seed: int, snrs, iters: int, device, prec: str = "float32") -> dict:
    """Frame 0 of a sweep group's runner call of ``len(snrs) * iters`` runs
    drawn from ``seed``: the draws, the channel at each run's SNR, the
    frame's training from the Dirac start with each run's variance, and each
    point's evaluation. Returns {"ser" (R, 4), "mi" (R, 2), "var_est" (R,
    2)}, runs in grid order, and {"var" (points, 2)}."""
    with ref.precision(prec), torch.no_grad():
        n_frame, steps, stride, crop, tx_sl, wfn = ref._frame_geometry(cfg)
        st = ref.Setup(cfg, n_frame, device)
        snr_run = runs_snr(snrs, iters)
        R = snr_run.shape[0]
        gen = torch.Generator(device=st.device)
        gen.manual_seed(int(seed))
        rx, tx = _physics(st, st.theta(0), *st.draws(gen, R), snr_run)
        var_pt = np.stack([np.full(2, point_var(st, s), np.float32) for s in snrs])
        var_run = torch.from_numpy(np.repeat(var_pt, iters, axis=0)).to(st.device)
        params = ref.dirac(cfg["m_est"], R, st.device)
        with torch.enable_grad():
            _, _, var_est, q, out = ref.train_frame(
                _with_var(st, var_run), params, ref.zero_moments(params), rx, 0,
                float(cfg["n_lrhalf"]) * steps, cfg["batch_len"], stride, crop)
        ser, mi = [], []
        for j in range(len(snrs)):
            blk = slice(j * iters, (j + 1) * iters)
            st_j = _with_var(st, var_run[j * iters])
            s, m = ref.eval_frame(st_j, q[blk], out[blk], tx[blk][..., tx_sl], wfn)
            ser.append(s)
            mi.append(m)
        return {"ser": torch.cat(ser), "mi": torch.cat(mi),
                "var_est": var_est.to(torch.float64).mean(-2).float(),
                "var": torch.from_numpy(var_pt)}


def final_ser(cfg: dict, w: torch.Tensor, seed: int, snr_db: float) -> torch.Tensor:
    """Soft SER (R, 2) of one point's final butterflies w (R, 2, 4, M) on a
    fresh frame drawn from ``seed`` at the last frame's angle and the
    point's SNR."""
    return ref.eval_params({**cfg, "snr_db": float(snr_db)}, w, seed, cfg["num_frames"] - 1)
