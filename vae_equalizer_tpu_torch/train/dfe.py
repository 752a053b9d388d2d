"""LMMSE + DFE baseline over an SNR sweep (the reference's DFE_MQAM_shaping).

Port of ``vae_equalizer_tpu/train/dfe.py: run_lmmse_dfe`` (the module-level
script of AWGN_channel/DFE_MQAM_shaping.py:246-295). Known-channel
(non-blind) baselines at 1 sample per symbol with RC pulse shaping: the
closed-form Wiener filter, and a decision-feedback equalizer seeded with the
LMMSE's hard decisions. The JAX package runs one jitted program per (SNR,
epoch); here every frame of the sweep is drawn up front, the FIRs run
batched over all frames, and the decision loops of all len(snrs) x
num_epochs frames run as ONE kernel J launch (``ops/dfe_kernel.py``, its
plain version on the CPU).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..channels import channel_ir, make_awgn_simulator
from ..core import make_constellation, resolve_device
from ..metrics import find_shift_symb_siso, ser_const_siso
from ..models.lmmse_dfe import (
    complex_fir,
    compute_feedback,
    compute_feedforward,
    compute_lmmse,
    dfe_equalize,
    nearest_neighbor,
)
from ..utils.config import LmmseDfeConfig
from .eval_utils import margin_weight, roll_time

__all__ = ["SNR_VEC", "run_lmmse_dfe"]

Progress = Callable[[int, dict], None] | None

SNR_VEC = tuple(range(15, 23))


def _planes(c: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.stack([c.real, c.imag]).astype(np.float32)).to(device)


def _dfe_chains(cfg: LmmseDfeConfig, seed: int, device, snrs=SNR_VEC, draws=None) -> dict:
    """Every frame of the sweep through the filters, up to the decision loop.

    The frames are drawn from a ``torch.Generator`` seeded with ``seed``, or
    from ``draws(snr_index, epoch) -> (levels (2, n_conv), noise (2,
    sig_len))`` where given (how tests feed the JAX package's draws). Returns
    {"tx" (S, E, 2, N), "soft_full" (S, E, 2, N + 1) the LMMSE output,
    "ff_out" (S, E, 2, N) the feedforward output, "fb" (S, 1, 2, K2) the
    feedback taps, "init_idx" (S, E, N) the LMMSE's hard decisions (shifted
    by one symbol, DFE_MQAM_shaping.py:278), "points" (2, n_points),
    "amps"} on ``device``, S = len(snrs), E = cfg.num_epochs.
    """
    const = make_constellation(cfg.mod, cfg.nu)
    h_up, m_orig = channel_ir(cfg.channel, 1)
    h_c = h_up.astype(np.complex64)
    n = cfg.n_valid
    n1 = (cfg.lmmse_order - 1) // 2 + 1
    sims = [make_awgn_simulator(const, snr, h_up, m_orig, n, 1, pulse="rc", device=device)
            for snr in snrs]
    if draws is None:
        rng = torch.Generator(device=device)
        rng.manual_seed(seed)
        draws = lambda si, epoch: sims[si].draws(rng, ())  # noqa: E731
    rx, tx = [], []
    for si, sim in enumerate(sims):
        lev, noi = zip(*(draws(si, epoch) for epoch in range(cfg.num_epochs)))
        r, t, _ = sim.physics(torch.stack(lev).to(device), torch.stack(noi).to(device))
        rx.append(r)
        tx.append(t)
    rx, tx = torch.stack(rx), torch.stack(tx)  # (S, E, 2, N)
    filt = {"lmmse": [], "ff": [], "fb": []}
    for snr in snrs:
        ff = compute_feedforward(h_c, snr, cfg.m_dfe)
        filt["lmmse"].append(_planes(compute_lmmse(h_c, snr, cfg.lmmse_order, n1), device))
        filt["ff"].append(_planes(ff, device))
        filt["fb"].append(_planes(compute_feedback(h_c, ff), device))
    lmmse, ff, fb = (torch.stack(filt[k])[:, None] for k in ("lmmse", "ff", "fb"))  # (S, 1, 2, K)
    points = torch.from_numpy(np.stack([const.points.real, const.points.imag]).astype(np.float32))
    points = points.to(device)
    soft_full = complex_fir(rx, lmmse)  # even order: N + 1 outputs
    return {"tx": tx, "soft_full": soft_full, "ff_out": complex_fir(rx, ff)[..., :n], "fb": fb,
            "init_idx": nearest_neighbor(soft_full[..., 1 : 1 + n], points), "points": points,
            "amps": torch.from_numpy(const.amps).to(device)}


def run_lmmse_dfe(cfg: LmmseDfeConfig, seed: int, device="cuda", snrs=SNR_VEC,
                  progress: Progress = None, draws=None) -> dict:
    """Evaluate the LMMSE and DFE SER over an SNR grid.

    The parameters come in JAX's order (``train/dfe.py: run_lmmse_dfe``)
    with ``device`` inserted third and the port's own ``draws`` (see
    ``_dfe_chains``) last. ``progress(epoch, {"snr", "ser_mmse", "ser_dfe"})``
    is called per (SNR, epoch) after the sweep.

    Returns {"ser_mmse" (num_snr, epochs), "ser_dfe" (num_snr, epochs),
    "snrs" (num_snr,)}.
    """
    device = resolve_device(device)
    n = cfg.n_valid
    margin = cfg.n_cut + 11
    c = _dfe_chains(cfg, seed, device, snrs, draws)
    tx, amps = c["tx"], c["amps"]

    soft = c["soft_full"][..., :n]
    shift = find_shift_symb_siso(soft, tx, 21)
    ser_mmse = ser_const_siso(roll_time(soft, shift), tx, amps, weight=margin_weight(n, shift, margin))

    dfe_idx = dfe_equalize(c["ff_out"], c["fb"], c["points"], c["init_idx"])  # one launch
    hard = c["points"][:, dfe_idx.long()].movedim(0, -2)  # (S, E, 2, N)
    shift_d = find_shift_symb_siso(hard, tx, 24)
    ser_dfe = ser_const_siso(roll_time(hard, shift_d), tx, amps,
                             weight=margin_weight(n, shift_d, margin))

    ser_mmse, ser_dfe = (s.cpu().numpy().astype(np.float32) for s in (ser_mmse, ser_dfe))
    if progress:
        for si, snr in enumerate(snrs):
            for epoch in range(cfg.num_epochs):
                progress(epoch, {"snr": snr, "ser_mmse": float(ser_mmse[si, epoch]),
                                 "ser_dfe": float(ser_dfe[si, epoch])})
    return {"ser_mmse": ser_mmse, "ser_dfe": ser_dfe, "snrs": np.asarray(snrs)}
