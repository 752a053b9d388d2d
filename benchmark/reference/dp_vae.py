"""Plain PyTorch reference of the dual-polarization VAE-LE: channel, online
training, evaluation and the streaming receiver's block.

The benchmark's yardstick for ``correct``. It imports neither the program
(``vae_equalizer_tpu_torch``) nor JAX: the equations are written out here in
plain ``torch`` operations, float32, with TF32 off unless ``precision`` asks
for the lower-precision control ("tf32"). It follows the reference
implementation (kit-cel/vae-equalizer, optical_DP_channel/shared_funcs.py and
func_VAELE_DP_MQAM_shaping.py / func_VAEflex_DP_MQAM_shaping.py):

* the channel: PCS levels from uniforms by the inverse CDF, RRC pulse,
  chromatic dispersion, PMD and a polarization rotation theta with a static
  IQ phase in one frequency-domain pass, then AWGN at the configured SNR;
* the equalizer: the 2x2 butterfly FIR (twoXtwoFIR) and the PCS soft
  demapper softmin((out - a)^2 / (2 var) + nu_sc a^2);
* the loss: the DP ELBO with the PCS prior, its gradient by autograd, and
  Adam (b1 .9, b2 .999, eps 1e-8 outside the sqrt, bias correction at t =
  step + 1, w's lr halved once at ``lr_half_step``);
* the evaluation: the per-pol time shift and polarization assignment by
  correlation, the SER over the 4 rotations x IQ flip, the SER of the
  constellation output with PCS decision boundaries, and the MI maximized
  over the 8 ambiguities, each under the reference's edge masks.

Where the reference draws its channel from a seed, it draws the uniforms and
the noise with a ``torch.Generator`` in the order the experiment draws them
(levels, then noise, per frame), so one seed gives both sides one input.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

__all__ = ["Setup", "adam", "butterfly", "demap", "dirac", "elbo", "eval_frame", "eval_params",
           "frame0", "levels", "precision", "stream_block", "train_frame", "zero_moments"]

_MOD_SIZES = {"4-QAM": 2, "16-QAM": 4, "64-QAM": 8, "256-QAM": 16}
_CHANNELS = {"h0": np.array([1.0 + 0.0j], np.complex64)}
_PULSE_T, _PULSE_BETA = 8, 0.1
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
_N_SHIFT, _CORR_LEN, _MARGIN = 21, 2000, 11


def levels(mod: str) -> int:
    """Amplitude levels per dimension of a square QAM ("64-QAM": 8)."""
    return _MOD_SIZES[mod]


@contextlib.contextmanager
def precision(name: str):
    """float32 with TF32 off ("float32"), or matrix products in TF32
    ("tf32", the control one step below the configuration's float32)."""
    if name not in ("float32", "tf32"):
        raise ValueError(f"precision {name!r}: float32 or tf32")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = name == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------- channel


def _rrcfir(T: int, sps: int, beta: float) -> np.ndarray:
    t = np.arange(-T * sps / 2, T * sps / 2, 1 / sps, dtype=np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = (np.sin(np.pi * t * (1 - beta)) + 4 * beta * t * np.cos(np.pi * t * (1 + beta))) / (
            np.pi * t * (1 - (4 * beta * t) ** 2))
    h[np.abs(t) == 1 / 4 / beta] = beta / np.sqrt(2) * (
        (1 + 2 / np.pi) * np.sin(np.pi / 4 / beta) + (1 - 2 / np.pi) * np.cos(np.pi / 4 / beta))
    h[t == 0] = 1 + beta * (4 / np.pi - 1)
    return (h / np.linalg.norm(h)).astype(np.float32)


def _fft_len(n: int) -> int:
    """Smallest L >= n of the form 2^a 3^b 5^c 7^d with a >= 5."""
    def ok(m):
        a = 0
        while m % 2 == 0:
            m, a = m // 2, a + 1
        for p in (3, 5, 7):
            while m % p == 0:
                m //= p
        return m == 1 and a >= 5
    while not ok(n):
        n += 1
    return n


class Setup:
    """One configuration's constants on ``device``: the constellation (amps
    float32, P, nu_sc, pow_mean), the demapper variance, and the channel for
    frames of ``n_sym`` symbols."""

    def __init__(self, cfg: dict, n_sym: int, device):
        self.cfg, self.N, self.device = cfg, n_sym, torch.device(device)
        n_lev = _MOD_SIZES[cfg["mod"]]
        lev = np.arange(-(n_lev - 1), n_lev, 2, dtype=np.float64)
        amps64 = lev / np.sqrt(np.mean(np.abs(lev[:, None] + 1j * lev[None, :]) ** 2))
        sc = np.min(np.abs(amps64))
        P = np.exp(-cfg["nu"] * np.abs(amps64 / sc) ** 2)
        self.P64 = P / np.sum(P)
        self.amps_np = amps64.astype(np.float32)
        self.nu_sc = float(cfg["nu"] / sc**2)
        self.pow_mean = float(2.0 * np.sum(self.P64 * amps64**2))
        self.amps = torch.from_numpy(self.amps_np).to(self.device)
        self.P = torch.from_numpy(self.P64.astype(np.float32)).to(self.device)
        var = np.float32(self.pow_mean / 10 ** (cfg["snr_db"] / 10) / 2)
        self.var = torch.full((2,), float(var), dtype=torch.float32, device=self.device)

        sps = cfg["sps"]
        h_orig = _CHANNELS[cfg["channel"]]
        h_up = np.zeros(sps * (h_orig.shape[-1] - 1) + 1, np.complex64)
        h_up[::sps] = h_orig
        h_up = h_up / np.linalg.norm(h_up)
        pulse = _rrcfir(_PULSE_T, sps, _PULSE_BETA)
        h_comb = np.convolve(pulse.astype(np.complex128), h_up)
        m_up = h_up.shape[-1]
        self.n_conv = n_sym + m_up + 4 * _PULSE_T
        self.up_len = sps * (self.n_conv - 1) + 1
        self.h_len = h_comb.shape[-1]
        self.sig_len = self.up_len - pulse.shape[-1] - m_up + 2
        self.offset = _PULSE_T + m_up - 1
        self.fft_len = _fft_len(self.up_len)
        freq = np.fft.fftfreq(self.fft_len, 1 / cfg["symb_rate"] / sps)
        cd = np.exp(1j * 2 * (np.pi * freq) ** 2 * cfg["tau_cd"]) * np.fft.fft(
            np.pad(h_comb, (0, self.fft_len - self.h_len)))
        pmd = np.pi * cfg["tau_pmd"] * freq
        f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(self.device)
        self._cd = torch.complex(f32(cd.real), f32(cd.imag))
        self._d0 = torch.complex(f32(np.cos(pmd)), f32(np.sin(pmd)))
        self._d1 = torch.complex(f32(np.cos(pmd)), f32(-np.sin(pmd)))
        phi = np.asarray(cfg["phi_iq"], np.float64)
        e_re, e_im = np.cos(phi).astype(np.float32), (-np.sin(phi)).astype(np.float32)
        self._e = [torch.complex(f32(e_re[i]), f32(e_im[i])) for i in range(2)]

    def levels(self, u: torch.Tensor) -> torch.Tensor:
        """Inverse CDF of the PCS pmf at uniforms u: amps[0] plus one float32
        step per crossed CDF edge."""
        cum = np.cumsum(self.P64.astype(np.float32))
        steps = np.diff(self.amps_np)
        a = torch.full(u.shape, float(self.amps_np[0]), dtype=torch.float32, device=u.device)
        for lev in range(1, self.amps_np.shape[0]):
            a = a + torch.where(u >= float(cum[lev - 1]), float(steps[lev - 1]), 0.0)
        return a

    def draws(self, gen: torch.Generator, runs: int):
        """(levels (R, 4, n_conv), unit noise (R, 2, 2, sig_len)): one frame's draws."""
        u = torch.rand((runs, 4, self.n_conv), generator=gen, device=self.device)
        noise = torch.randn((runs, 2, 2, self.sig_len), generator=gen, device=self.device)
        return self.levels(u), noise

    def clean(self, theta: float, levels: torch.Tensor) -> torch.Tensor:
        """The noiseless received signal (R, 2, 2, sig_len) of levels (R, 4, n_conv)."""
        R, sps = levels.shape[0], self.cfg["sps"]
        up = torch.zeros((R, 2, 2, self.n_conv * sps), dtype=torch.float32, device=self.device)
        up[..., ::sps] = levels.reshape(R, 2, 2, self.n_conv)
        up = up[..., : self.up_len]
        zf = torch.fft.fft(torch.complex(up[:, :, 0], up[:, :, 1]), n=self.fft_len, dim=-1)
        th = torch.tensor(theta, dtype=torch.float32, device=self.device)
        ct, st = torch.cos(th), torch.sin(th)
        (e0, e1), d0, d1 = self._e, self._d0, self._d1
        h00 = ct * e0 * d0 * ct * e0 + (-st * e0) * d1 * (-st * e1)
        h01 = ct * e0 * d0 * st * e0 + (-st * e0) * d1 * ct * e1
        h10 = st * e1 * d0 * ct * e0 + ct * e1 * d1 * (-st * e1)
        h11 = st * e1 * d0 * st * e0 + ct * e1 * d1 * ct * e1
        o0 = (h00 * zf[:, 0] + h01 * zf[:, 1]) * self._cd
        o1 = (h10 * zf[:, 0] + h11 * zf[:, 1]) * self._cd
        z = torch.fft.ifft(torch.stack([o0, o1], dim=1), dim=-1)
        z = z[..., self.h_len - 1 : self.h_len - 1 + self.sig_len]
        return torch.stack([z.real, z.imag], dim=2).to(torch.float32)

    def sigma(self, sig: torch.Tensor) -> torch.Tensor:
        """The noise std (R,) that sets the configured SNR on the clean signal."""
        p = torch.mean(sig**2, dim=(1, 2, 3), dtype=torch.float64).to(torch.float32)
        return torch.sqrt(p * 2 * self.cfg["sps"] / 2 / 10 ** (self.cfg["snr_db"] / 10))

    def physics(self, theta: float, levels: torch.Tensor, noise: torch.Tensor):
        """(rx (R, 2, 2, sps N), tx (R, 2, 2, N), sigma (R,))."""
        sig = self.clean(theta, levels)
        sigma = self.sigma(sig)
        sig = sig + sigma[:, None, None, None] * noise
        rx = sig[..., : self.cfg["sps"] * self.N].contiguous()
        tx = levels[:, :, self.offset : self.offset + self.N].reshape(-1, 2, 2, self.N)
        return rx, tx, sigma

    def theta(self, frame: int) -> float:
        """Frame ``frame``'s polarization angle, as float32 arithmetic gives it."""
        c = self.cfg
        return float(np.float32(c["theta"]) + np.float32(c["theta_diff"]) * np.float32(frame))


# ---------------------------------------------------------------- equalizer and loss


def butterfly(w: torch.Tensor, x: torch.Tensor, sps: int) -> torch.Tensor:
    """2x2 butterfly FIR: w (..., 2, 4, M), x (..., 2, 2, L) zero-padded by
    M // 2 -> (..., 2, 2, N) at stride sps. The I output reads (x_I^x, x_I^y,
    -x_Q^x, -x_Q^y), the Q output (x_Q^x, x_Q^y, x_I^x, x_I^y)."""
    m = w.shape[-1]
    x_i = torch.cat([x[..., :, 0, :], -x[..., :, 1, :]], dim=-2)
    x_q = torch.cat([x[..., :, 1, :], x[..., :, 0, :]], dim=-2)
    win = lambda v: torch.nn.functional.pad(v, (m // 2, m // 2)).unfold(-1, m, sps)
    out_i = torch.einsum("...oik,...ink->...on", w, win(x_i))
    out_q = torch.einsum("...oik,...ink->...on", w, win(x_q))
    return torch.stack([out_i, out_q], dim=-2)


def demap(out: torch.Tensor, amps: torch.Tensor, var: torch.Tensor, nu_sc: float) -> torch.Tensor:
    """PCS soft demapper: out (..., 2, 2, N) -> q (..., 2, 2n, N), I levels then Q."""
    d = out[..., None, :] - amps[:, None]
    metric = d * d / (2.0 * var[..., :, None, None, None]) + nu_sc * (amps * amps)[:, None]
    q = torch.softmax(-metric, dim=-2)
    return q.reshape(q.shape[:-3] + (2 * amps.shape[0], q.shape[-1]))


def elbo(q, rx, h, amps, P, eps: float = 1e-12):
    """DP ELBO with the PCS prior: q (..., 2, 2n, N), rx (..., 2, 2, sps N), h
    (..., 2, 2, 2, M) -> (loss (...), var_est (..., 2))."""
    n_samp, n = rx.shape[-1], amps.shape[0]
    sps = n_samp // q.shape[-1]
    mh2 = 2 * (h.shape[-1] // 2)
    a = amps[:, None]
    eq = torch.stack([(q[..., :n, :] * a).sum(-2), (q[..., n:, :] * a).sum(-2)], dim=-2)
    eq2 = torch.stack([(q[..., :n, :] * a * a).sum(-2), (q[..., n:, :] * a * a).sum(-2)], dim=-2)
    def up(v):  # onto the sps-upsampled grid, zeros between symbols
        u = torch.zeros(v.shape[:-1] + (n_samp,), dtype=v.dtype, device=v.device)
        u[..., ::sps] = v
        return u

    eq, eq2 = up(eq), up(eq2)
    var = eq2 - eq * eq
    hh = h[..., : mh2 + 1]
    hr, hi = hh[..., 0, :], hh[..., 1, :]
    bank = torch.stack([torch.stack([hr, -hi], dim=-2), torch.stack([hi, hr], dim=-2)], dim=-4)
    bank = bank.reshape(bank.shape[:-5] + (4, 4, bank.shape[-1])).flip(-1)
    cols = eq.reshape(eq.shape[:-3] + (4, n_samp)).unfold(-1, mh2 + 1, 1)
    d = torch.einsum("...oij,...inj->...on", bank, cols)
    d = d.reshape(d.shape[:-2] + (2, 2, n_samp - mh2))
    d_re, d_im = d[..., 0, :], d[..., 1, :]
    v = var.sum(-2)  # (..., nu, N)
    c0 = torch.cat([torch.zeros(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device),
                    torch.cumsum(v, -1)], -1)
    j = torch.arange(mh2 + 1, device=v.device)
    s = c0[..., n_samp - j] - c0[..., mh2 - j]  # S[nu, j] = sum_{t=Mh-j}^{N-1-j} var
    e_term = torch.einsum("...xnj,...nj->...x", (hh * hh).sum(-2), s)
    rx_w = rx[..., mh2 // 2 : n_samp - mh2 // 2]
    c = (rx_w * rx_w).sum((-2, -1)) - 2.0 * (rx_w[..., 0, :] * d_re + rx_w[..., 1, :] * d_im).sum(-1)
    c = c + (d_re * d_re + d_im * d_im).sum(-1) + e_term
    q_c = q[..., mh2 // 2 : q.shape[-1] - mh2 // 2]
    kl = (-q_c * torch.log(q_c / P.repeat(2)[:, None] + eps)).sum((-3, -2, -1))
    n_eff = n_samp - mh2
    return (n_eff * torch.log(c)).sum(-1) - kl, (c / n_eff).detach()


def adam(params: dict, opt: dict, grads: dict, lr: float, step: int, lr_half_step: float):
    """One Adam update of {"w", "h"} at global step ``step``."""
    bc1, bc2 = 1.0 - _B1 ** (step + 1), 1.0 - _B2 ** (step + 1)
    new_p, new_o = {}, {}
    for k, lr_k in (("w", lr * (0.5 if step >= lr_half_step else 1.0)), ("h", lr)):
        m = _B1 * opt["m" + k] + (1 - _B1) * grads[k]
        v = _B2 * opt["v" + k] + (1 - _B2) * grads[k] * grads[k]
        new_p[k] = params[k] - lr_k * ((m / bc1) / (torch.sqrt(v / bc2) + _EPS))
        new_o["m" + k], new_o["v" + k] = m, v
    return new_p, new_o


def dirac(m: int, runs: int, device) -> dict:
    """Dirac-initialized butterfly w (R, 2, 4, M) and channel estimate h (R, 2, 2, 2, M)."""
    w = torch.zeros((runs, 2, 4, m), dtype=torch.float32, device=device)
    w[:, 0, 0, m // 2] = w[:, 1, 1, m // 2] = 1.0
    h = torch.zeros((runs, 2, 2, 2, m), dtype=torch.float32, device=device)
    h[:, 0, 0, 0, m // 2] = h[:, 1, 1, 0, m // 2] = 1.0
    return {"w": w, "h": h}


def zero_moments(params: dict) -> dict:
    return {p + k: torch.zeros_like(params[k]) for k in ("w", "h") for p in ("m", "v")}


def train_frame(st: Setup, params: dict, opt: dict, rx: torch.Tensor, step0: int,
                lr_half_step: float, bl: int, stride: int, crop: slice):
    """One frame of online training, window after window: window m covers
    symbols [m stride, m stride + bl); its forward pass (before the update)
    gives the eval streams, cropped to ``crop``. Returns (params, opt,
    var_est (R, steps, 2), q (R, 2, 2n, steps x crop), out (R, 2, 2, ...))."""
    cfg, sps = st.cfg, st.cfg["sps"]
    n_sym = rx.shape[-1] // sps
    n_win = n_sym // bl if stride == bl else (n_sym - bl) // stride
    var_est, qs, outs = [], [], []
    for m in range(n_win):
        x = rx[..., sps * stride * m : sps * (stride * m + bl)]
        w, h = (params[k].detach().requires_grad_() for k in ("w", "h"))
        out = butterfly(w, x, sps)
        q = demap(out, st.amps, st.var, st.nu_sc)
        loss, v = elbo(q, x, h, st.amps, st.P)
        gw, gh = torch.autograd.grad(loss.sum(), (w, h))
        params, opt = adam({"w": w.detach(), "h": h.detach()}, opt, {"w": gw, "h": gh},
                           cfg["lr"], step0 + m, lr_half_step)
        var_est.append(v)
        qs.append(q.detach()[..., crop])
        outs.append(out.detach()[..., crop])
    return params, opt, torch.stack(var_est, -2), torch.cat(qs, -1), torch.cat(outs, -1)


# ---------------------------------------------------------------- evaluation


def _sync(e: torch.Tensor, tx: torch.Tensor):
    """Per-pol shift and pol assignment r (0 XY, 1 YX) by correlating e (..., 2, L)
    with tx (..., 2, 2, L) over 21 cyclic shifts of the first 2000 symbols."""
    e, tx = e[..., :_CORR_LEN], tx[..., :_CORR_LEN]
    e_mat = torch.stack([torch.roll(e, s, dims=-1)
                         for s in range(-(_N_SHIFT // 2), _N_SHIFT - _N_SHIFT // 2)], dim=-2)
    corr = torch.einsum("...icl,...bsl->...cbis", tx, e_mat).abs()
    cmax_c, cind_c = corr.max(-1).values, corr.argmax(-1)
    best_c = cmax_c.argmax(-3)
    cmax = cmax_c.max(-3).values
    pick = torch.gather(cind_c, -3, best_c.unsqueeze(-3)).squeeze(-3)
    xy = torch.stack([pick[..., 0, 0], pick[..., 1, 1]], -1)
    yx = torch.stack([pick[..., 0, 1], pick[..., 1, 0]], -1)
    use_xy = cmax[..., 0, 0] + cmax[..., 1, 1] >= cmax[..., 0, 1] + cmax[..., 1, 0]
    shift = torch.where(use_xy[..., None], _N_SHIFT // 2 - xy, _N_SHIFT // 2 - yx)
    return shift, torch.where(use_xy, 0, 1)


def _indices(tx: torch.Tensor, n_lev: int) -> torch.Tensor:
    return torch.round(math.sqrt((n_lev**2 - 1) / 6) * tx + (n_lev - 1) / 2).to(torch.int64)


def _align(tx, shift, r, weight_fn):
    """tx (..., 2, 2, N) and the mask in the equalizer's frame: per equalizer
    pol j the tx pol (j + r) % 2 rolled by its shift; the mask is
    ``weight_fn(t)`` at the shifted positions t (..., 2, N)."""
    n = tx.shape[-1]
    swap = r != 0
    tx_p = torch.where(swap[..., None, None, None], tx.flip(-3), tx)
    s_p = torch.where(swap[..., None], shift.flip(-1), shift).to(torch.int64)
    t = torch.remainder(torch.arange(n, device=tx.device) - s_p[..., None], n)
    return torch.gather(tx_p, -1, t[..., None, :].expand(tx_p.shape)), weight_fn(t)


def _wmean(err, w):
    w = torch.broadcast_to(w, err.shape).to(torch.float64)
    return ((err.to(torch.float64) * w).sum(-1) / w.sum(-1)).to(torch.float32)


def ser_soft(q: torch.Tensor, tx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-pol SER of the posteriors' decisions, min over 4 rotations x IQ flip."""
    n = q.shape[-2] // 2
    d_i, d_q = q[..., :n, :].argmax(-2), q[..., n:, :].argmax(-2)
    data = _indices(tx, n)
    inv = lambda a: (n - 1) - a
    variants = ((d_i, d_q), (inv(d_i), inv(d_q)), (inv(d_q), d_i), (d_q, inv(d_i)))
    sers = [_wmean((vi != data[..., 0, :]) | (vq != dq), w) for vi, vq in variants
            for dq in (data[..., 1, :], inv(data[..., 1, :]))]
    return torch.stack(sers).min(0).values


def ser_const(out, tx, amps, nu_sc, var, w):
    """Per-pol SER of the constellation output, PCS decision boundaries
    (1 + 2 nu_sc var)(a_i + a_i+1) / 2, after scaling to tx's mean magnitude."""
    n = amps.shape[0]
    data = _indices(tx, n)
    d_i, d_q = data[..., 0, :], data[..., 1, :]
    bound = (1 + 2 * nu_sc * var[..., 0, None]) * (amps[:-1] + amps[1:]) / 2
    mag = lambda a, b: torch.sqrt(a**2 + b**2).to(torch.float64)
    wb = torch.broadcast_to(w, d_i.shape).to(torch.float64)
    m_tx = (mag(amps[d_i], amps[d_q]) * wb).sum((-2, -1)) / wb.sum((-2, -1))
    m_rx = (mag(out[..., 0, :], out[..., 1, :]) * wb).sum((-2, -1)) / wb.sum((-2, -1))
    out = out * (m_tx.to(torch.float32) / m_rx.to(torch.float32))[..., None, None, None]
    pos = sum((out >= bound[k]).to(torch.int64) for k in range(n - 1))
    neg = sum((out <= -bound[k]).to(torch.int64) for k in range(n - 1))
    p0, p1, n0, n1 = pos[..., 0, :], pos[..., 1, :], neg[..., 0, :], neg[..., 1, :]
    bad = (~torch.isfinite(out)).any(-2)
    i_src, q_src = (p0, n0, n1, p1), (p1, n1, p0, n0)
    errs = [(i_src[v] != d_i) | (q_src[v] != dq) | bad for dq in (d_q, (n - 1) - d_q)
            for v in range(4)]
    return torch.stack([_wmean(e, w) for e in errs]).min(0).values


def mi(q, tx, amps, P, w, eps: float = 1e-12):
    """Per-pol MI (bits per QAM symbol) maximized over the 8 ambiguities."""
    n = amps.shape[0]
    idx = _indices(tx, n)
    i_i, i_q = idx[..., 0, :], idx[..., 1, :]
    i_ir, i_qr = (n - 1) - i_i, (n - 1) - i_q
    lqi, lqq = torch.log2(q[..., :n, :] + eps), torch.log2(q[..., n:, :] + eps)
    lp = torch.log2(P)
    wf = w.to(torch.float64)
    red = lambda t: (t.to(torch.float64) * wf).sum(-1)
    sel = lambda lq, i: red(torch.gather(lq, -2, i.unsqueeze(-2)).squeeze(-2))
    a1, a2, a3, a4 = sel(lqi, i_i), sel(lqi, i_ir), sel(lqq, i_i), sel(lqq, i_ir)
    b1, b2, b3, b4 = sel(lqq, i_q), sel(lqq, i_qr), sel(lqi, i_q), sel(lqi, i_qr)
    best = torch.stack([a1 + b1, a2 + b2, a4 + b3, a3 + b4, a1 + b2, a2 + b1, a3 + b3,
                        a4 + b4]).max(0).values
    wsum = torch.broadcast_to(wf, i_i.shape).sum(-1)
    return ((best - red(lp[i_i] + lp[i_q])) / wsum).to(torch.float32)


def _roll_pol(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return torch.where(r[..., None] != 0, x.flip(-1), x)


def batch_cut_weight(m_max: int, bl: int, shift0, max_shift, n_cut: int, t):
    """The VAE's eval mask: per batch the first bl - shift0 - n_cut symbols,
    flattened, then [11 : -11 - max|shift|]."""
    j, mb = t % bl, t // bl
    keep = bl - shift0 - n_cut
    pos = mb * keep + j
    return ((j < keep) & (pos >= _MARGIN) & (pos < m_max * keep - _MARGIN - max_shift)).float()


def margin_weight(n: int, max_shift, t):
    """The VAEflex eval mask [11 : n - 11 - max|shift|]."""
    return ((t >= _MARGIN) & (t < n - _MARGIN - max_shift)).float()


def eval_frame(st: Setup, q, out, tx, weight_fn):
    """(ser (R, 4): constellation then soft, per tx pol; mi (R, 2)) of a frame's
    streams q (R, 2, 2n, N), out (R, 2, 2, N) against tx (R, 2, 2, N)."""
    t = torch.arange(tx.shape[-1], device=tx.device)

    def aligned(sh, rr):
        w = weight_fn(sh[..., 0, None], sh.abs().max(-1).values[..., None], t)
        wfn = lambda tt: torch.gather(torch.broadcast_to(w[..., None, :], tt.shape[:-1] + w.shape[-1:]),
                                      -1, tt)
        return _align(tx, sh, rr, wfn)

    n = st.amps.shape[0]
    shift, r = _sync((q[..., :n, :] * st.amps[:, None]).sum(-2), tx)
    tx_al, w_al = aligned(shift, r)
    s_soft = _roll_pol(ser_soft(q, tx_al, w_al), r)
    mi_ = _roll_pol(mi(q, tx_al, st.amps, st.P, w_al), r)
    shift_c, r_c = _sync(out[..., :, 0, :], tx)
    tx_c, w_c = aligned(shift_c, r_c)
    s_const = _roll_pol(ser_const(out, tx_c, st.amps, st.nu_sc, st.var, w_c), r_c)
    return torch.cat([s_const, s_soft], -1), mi_


# ---------------------------------------------------------------- the checks


def _frame_geometry(cfg: dict):
    """(symbols a frame, windows a frame, window stride, crop, tx slice,
    weight_fn) of the VAE (windows back to back) or VAEflex (a window every
    flex_step symbols, the central flex_step of each recorded)."""
    bl = cfg["batch_len"]
    n_frame = cfg["n_frame_max"] // bl * bl
    if cfg["loss_type"] == "VAE":
        steps = n_frame // bl
        wfn = lambda s0, ms, t: batch_cut_weight(steps, bl, s0, ms, cfg["n_cut"], t)
        return n_frame, steps, bl, slice(None), slice(None), wfn
    fs = cfg["flex_step"]
    steps = (n_frame - bl) // fs
    m_max = steps * fs
    c0 = (bl - fs) // 2
    wfn = lambda s0, ms, t: margin_weight(m_max, ms, t)
    return n_frame, steps, fs, slice(c0, c0 + fs), slice(bl // 2, bl // 2 + m_max), wfn


def frame0(cfg: dict, seed: int, runs: int, device, prec: str = "float32") -> dict:
    """Frame 0 of an experiment of ``runs`` runs drawn from ``seed``: the
    draws, the channel, the frame's training from the Dirac start and its
    evaluation. Returns {"ser" (R, 4), "mi" (R, 2), "var_est" (R, 2)}."""
    with precision(prec), torch.no_grad():
        n_frame, steps, stride, crop, tx_sl, wfn = _frame_geometry(cfg)
        st = Setup(cfg, n_frame, device)
        gen = torch.Generator(device=st.device)
        gen.manual_seed(int(seed))
        rx, tx, _ = st.physics(st.theta(0), *st.draws(gen, runs))
        params = dirac(cfg["m_est"], runs, st.device)
        with torch.enable_grad():
            _, _, var_est, q, out = train_frame(st, params, zero_moments(params), rx, 0,
                                                float(cfg["n_lrhalf"]) * steps, cfg["batch_len"],
                                                stride, crop)
        ser, mi_ = eval_frame(st, q, out, tx[..., tx_sl], wfn)
        return {"ser": ser, "mi": mi_, "var_est": var_est.to(torch.float64).mean(-2).float()}


def eval_params(cfg: dict, w: torch.Tensor, seed: int, frame: int) -> torch.Tensor:
    """Soft SER (R, 2) of the butterflies w (R, 2, 4, M) on a fresh frame
    drawn from ``seed`` at frame ``frame``'s angle, under the VAEflex mask."""
    with precision("float32"), torch.no_grad():
        n = cfg["n_frame_max"]
        st = Setup(cfg, n, w.device)
        gen = torch.Generator(device=st.device)
        gen.manual_seed(int(seed))
        rx, tx, _ = st.physics(st.theta(frame), *st.draws(gen, w.shape[0]))
        q = demap(butterfly(w, rx, cfg["sps"]), st.amps, st.var, st.nu_sc)
        shift, r = _sync((q[..., : st.amps.shape[0], :] * st.amps[:, None]).sum(-2), tx)
        ms = shift.abs().max(-1).values[..., None]
        tx_al, w_al = _align(tx, shift, r, lambda tt: margin_weight(n, ms[..., None], tt))
        return _roll_pol(ser_soft(q, tx_al, w_al), r)


def stream_block(st: Setup, state: dict, block: torch.Tensor, adapt_batch: int,
                 prec: str = "float32"):
    """One block of the streaming receiver from ``state`` {"w", "h", "mw",
    "vw", "mh", "vh", "step", "tail"} (single run): block_len / adapt_batch
    Adam steps on the block's minibatches back to back (lr never halves),
    then the output pass over tail || block, the (M - 1) // sps warm-up
    symbols dropped. Returns (state after the block, q (2, 2n, L), out (2, 2, L))."""
    cfg, sps, m = st.cfg, st.cfg["sps"], st.cfg["m_est"]
    with precision(prec):
        params = {k: state[k][None] for k in ("w", "h")}
        opt = {k: state[k][None] for k in ("mw", "vw", "mh", "vh")}
        step = int(state["step"])
        mb = adapt_batch * sps
        for i in range(block.shape[-1] // mb):
            x = block[None, ..., i * mb : (i + 1) * mb]
            with torch.enable_grad():
                w, h = (params[k].detach().requires_grad_() for k in ("w", "h"))
                q = demap(butterfly(w, x, sps), st.amps, st.var, st.nu_sc)
                loss, _ = elbo(q, x, h, st.amps, st.P)
                gw, gh = torch.autograd.grad(loss.sum(), (w, h))
            params, opt = adam({"w": w.detach(), "h": h.detach()}, opt, {"w": gw, "h": gh},
                               cfg["lr"], step, float("inf"))
            step += 1
        with torch.no_grad():
            x = torch.cat([state["tail"], block], -1)
            out = butterfly(params["w"][0], x, sps)
            q = demap(out, st.amps, st.var, st.nu_sc)
        warm = (m - 1) // sps
        n_out = block.shape[-1] // sps
        new = {**{k: v[0] for k, v in params.items()}, **{k: v[0] for k, v in opt.items()},
               "step": step, "tail": block[..., -(m - 1):]}
        return new, q[..., warm : warm + n_out], out[..., warm : warm + n_out]
