"""Symbol-error rates robust to the blind-equalization ambiguities.

Port of ``vae_equalizer_tpu/metrics/ser.py`` (``_decode_levels``,
``_wmean``, ``_phase_variants``, ``ser_q_siso``, ``ser_const_siso``,
``ser_symb_siso``, ``ser_iqflip``, ``ser_iqflip_from_dec``,
``ser_constell_shaping``) with any leading batch dims. The DP estimators evaluate the 4 rotations x 2 IQ-flips and return
the minimum per polarization, the SISO one the 4 phase rotations;
``weight`` masks emulate the reference's data-dependent slicing
(optical_DP_channel/shared_funcs.py:188-287,
AWGN_channel/func_VAELE_MQAM_shaping.py:97-186,
func_CMA_MQAM_shaping.py:63-93).
"""

from __future__ import annotations

import math

import torch

from ..core.reduce import run_mean, run_sum

__all__ = ["ser_q_siso", "ser_const_siso", "ser_symb_siso", "ser_iqflip", "ser_iqflip_from_dec",
           "ser_constell_shaping"]


def _wmean(err: torch.Tensor, weight: torch.Tensor | None, dim) -> torch.Tensor:
    err = err.to(torch.float32)
    if weight is None:
        return run_mean(err, dim)
    w = torch.broadcast_to(weight.to(torch.float32), err.shape)
    return run_sum(err * w, dim) / run_sum(w, dim)


def _decode_levels(tx: torch.Tensor, num_lev: int) -> torch.Tensor:
    """Normalized amplitude levels -> integer indices 0..num_lev-1 (exact for
    every L: index = round(sqrt((L^2-1)/6) a + (L-1)/2))."""
    half = (num_lev - 1) / 2
    inv_step = math.sqrt((num_lev**2 - 1) / 6)
    return torch.round(inv_step * tx.to(torch.float32) + half).to(torch.int32)


def _indices(tx, tx_idx, num_lev):
    return (_decode_levels(tx, num_lev) if tx_idx is None else tx_idx).to(torch.int64)


def _phase_variants(dec: torch.Tensor, num_lev: int) -> torch.Tensor:
    """The 4 phase-rotation hypotheses (0, pi, pi/4, 3pi/4) of integer
    decisions dec (..., 2 I/Q, N) -> (4, ..., 2, N)."""
    inv = (num_lev - 1) - dec
    d_i, d_q = dec[..., 0, :], dec[..., 1, :]
    i_i, i_q = inv[..., 0, :], inv[..., 1, :]
    return torch.stack([dec, inv, torch.stack([i_q, d_i], dim=-2), torch.stack([d_q, i_i], dim=-2)])


def ser_q_siso(q: torch.Tensor, tx: torch.Tensor, num_lev: int,
               weight: torch.Tensor | None = None) -> torch.Tensor:
    """SER from SISO posteriors q (..., 2 num_lev, N) against tx (..., 2, N)
    levels, min over the 4 phase rotations (func_VAELE_MQAM_shaping.py:97-123);
    weight broadcastable to (..., N). Returns (...)."""
    data = _decode_levels(tx, num_lev).to(torch.int64)
    dec = torch.stack([torch.argmax(q[..., :num_lev, :], dim=-2),
                       torch.argmax(q[..., num_lev:, :], dim=-2)], dim=-2)
    err = torch.any(_phase_variants(dec, num_lev) != data, dim=-2)  # (4, ..., N)
    return _wmean(err, weight, -1).min(dim=0).values


def _ser_nearest(sig: torch.Tensor, tx: torch.Tensor, amps: torch.Tensor,
                 weight: torch.Tensor | None) -> torch.Tensor:
    """SISO SER of nearest-level decisions on sig (..., 2, N) against tx
    levels, min over the 4 phase rotations (first level on ties)."""
    num_lev = amps.shape[0]
    data = _decode_levels(tx, num_lev).to(torch.int64)
    dec = torch.argmin((sig[..., None, :] - amps[:, None]).abs(), dim=-2)  # (..., 2, N)
    err = torch.any(_phase_variants(dec, num_lev) != data, dim=-2)  # (4, ..., N)
    return _wmean(err, weight, -1).min(dim=0).values


def ser_const_siso(rx: torch.Tensor, tx: torch.Tensor, amps: torch.Tensor,
                   weight: torch.Tensor | None = None) -> torch.Tensor:
    """SER from the SISO constellation output rx (..., 2, N), scaled to tx's
    mean magnitude, against tx (..., 2, N) levels (func_CMA_MQAM_shaping.py:
    63-93, func_VAELE_MQAM_shaping.py:156-186); weight broadcastable to
    (..., N). Returns (...)."""
    txf = tx.to(torch.float32)
    mag_tx = _wmean(torch.sqrt(txf[..., 0, :] ** 2 + txf[..., 1, :] ** 2), weight, -1)
    mag_rx = _wmean(torch.sqrt(rx[..., 0, :] ** 2 + rx[..., 1, :] ** 2), weight, -1)
    return _ser_nearest(rx * (mag_tx / mag_rx)[..., None, None], tx, amps, weight)


def ser_symb_siso(rx: torch.Tensor, tx: torch.Tensor, amps: torch.Tensor, sps: int,
                  weight: torch.Tensor | None = None) -> torch.Tensor:
    """SER of the raw oversampled channel output rx (..., 2, sps N) against tx
    (..., 2, N): every sps-th sample, each component divided by
    sqrt(2 E[rx_c^2]), nearest level (the reference's unprocessed SER,
    func_VAELE_MQAM_shaping.py:125-154). Returns (...)."""
    n = tx.shape[-1]
    sig = rx[..., : n * sps : sps]
    sig = sig / torch.sqrt(2 * run_mean(sig**2, -1)[..., None])
    return _ser_nearest(sig, tx, amps, weight)


def ser_iqflip_from_dec(dec: torch.Tensor, tx: torch.Tensor | None, num_lev: int,
                        weight: torch.Tensor | None = None,
                        tx_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Per-pol SER from integer decisions, min over IQ-flip x 4 rotations.

    dec (..., 2 pol, 2 I/Q, N); tx (..., 2, 2, N) levels or tx_idx the
    level indices; weight broadcastable to (..., 2, N). Returns (..., 2).
    """
    dec = dec.to(torch.int64)
    data = _indices(tx, tx_idx, num_lev)
    inv = lambda a: (num_lev - 1) - a
    d_i, d_q = dec[..., 0, :], dec[..., 1, :]
    variants = ((d_i, d_q), (inv(d_i), inv(d_q)), (inv(d_q), d_i), (d_q, inv(d_i)))
    data_i = data[..., 0, :]
    data_q = (data[..., 1, :], inv(data[..., 1, :]))
    sers = [_wmean((vi != data_i) | (vq != dq), weight, -1) for vi, vq in variants for dq in data_q]
    return torch.stack(sers).min(dim=0).values


def ser_iqflip(q: torch.Tensor, tx: torch.Tensor, weight: torch.Tensor | None = None) -> torch.Tensor:
    """Per-pol SER from posteriors q (..., 2 pol, 2 num_lev, N), min over
    IQ-flip x 4 rotations (shared_funcs.py:188-222); tx (..., 2, 2, N)
    levels. Returns (..., 2)."""
    num_lev = q.shape[-2] // 2
    dec = torch.stack([torch.argmax(q[..., :num_lev, :], dim=-2),
                       torch.argmax(q[..., num_lev:, :], dim=-2)], dim=-2)
    return ser_iqflip_from_dec(dec, tx, num_lev, weight)


def ser_constell_shaping(rx: torch.Tensor, tx: torch.Tensor | None, amps: torch.Tensor,
                         nu_sc, var: torch.Tensor, weight: torch.Tensor | None = None,
                         tx_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Per-pol SER from the constellation output with PCS decision boundaries.

    rx (..., 2, 2, N) equalized symbols; tx levels or tx_idx indices
    (..., 2, 2, N); var (2,) demapper noise variance and nu_sc a float, or
    per run var (R, 2) and nu_sc (R,) over rx's leading runs axis. The MAP
    boundary between shaped neighbours moves inward: d = (1 + 2 nu_sc var)
    (a_i + a_{i+1}) / 2. Non-finite outputs always count as errors.
    """
    num_lev = amps.shape[0]
    data = _indices(tx, tx_idx, num_lev)
    tx_i, tx_q = amps[data[..., 0, :]], amps[data[..., 1, :]]
    data_i, data_q = data[..., 0, :], data[..., 1, :]
    data_q_inv = (num_lev - 1) - data_q

    if torch.is_tensor(nu_sc):  # per run (R,)
        nu_sc = nu_sc[..., None]
    d_vec = (1 + 2 * nu_sc * var[..., 0, None]) * (amps[:-1] + amps[1:]) / 2  # ([R,] n - 1)
    if d_vec.dim() > 1:  # per run: (R, 1, 1, 1, n - 1) against rx (R, 2, 2, N)
        d_vec = d_vec[:, None, None, None, :]

    mag_tx = _wmean(torch.sqrt(tx_i**2 + tx_q**2), weight, (-2, -1))
    mag_rx = _wmean(torch.sqrt(rx[..., 0, :] ** 2 + rx[..., 1, :] ** 2), weight, (-2, -1))
    rx = rx * (mag_tx / mag_rx)[..., None, None, None]

    dec_pos = torch.zeros(rx.shape, dtype=torch.int64, device=rx.device)  # bin(+rx)
    dec_neg = torch.zeros(rx.shape, dtype=torch.int64, device=rx.device)  # bin(-rx)
    for lev in range(num_lev - 1):
        dec_pos = dec_pos + (rx >= d_vec[..., lev])
        dec_neg = dec_neg + (rx <= -d_vec[..., lev])
    p0, p1 = dec_pos[..., 0, :], dec_pos[..., 1, :]
    n0, n1 = dec_neg[..., 0, :], dec_neg[..., 1, :]
    i_src = (p0, n0, n1, p1)
    q_src = (p1, n1, p0, n0)
    bad = torch.any(~torch.isfinite(rx), dim=-2)  # (..., 2, N)
    err = torch.stack(
        [(i_src[v] != data_i) | (q_src[v] != data_q) | bad for v in range(4)]
        + [(i_src[v] != data_i) | (q_src[v] != data_q_inv) | bad for v in range(4)]
    )
    return _wmean(err, weight, -1).min(dim=0).values
