"""Plain PyTorch reference of frame 0's per-step losses of the DP VAE or
VAEflex: the loss of every window, as the training step computes it before
its Adam update.

It imports neither the program (``vae_equalizer_tpu_torch``) nor JAX. It
takes the channel, the equalizer, the loss, Adam and the evaluation from
``benchmark/reference/dp_vae.py`` (float32, TF32 off unless ``prec`` asks
for the control, "tf32"), and trains frame 0 window by window as its
``train_frame`` does (either geometry of its ``_frame_geometry``: windows
back to back, or one every ``flex_step`` symbols with the central
``flex_step`` recorded), keeping each window's loss: the DP ELBO of the
window's posteriors under the state before the window's update, one number
a run.
"""

from __future__ import annotations

import torch

from . import dp_vae as ref

__all__ = ["frame0", "train_frame"]


def train_frame(st: ref.Setup, params: dict, opt: dict, rx: torch.Tensor, step0: int,
                lr_half_step: float, bl: int, stride: int, crop: slice):
    """``dp_vae.train_frame`` that also keeps each window's loss: (params,
    opt, var_est (R, steps, 2), q, out, losses (R, steps))."""
    cfg, sps = st.cfg, st.cfg["sps"]
    n_sym = rx.shape[-1] // sps
    n_win = n_sym // bl if stride == bl else (n_sym - bl) // stride
    var_est, qs, outs, losses = [], [], [], []
    for m in range(n_win):
        x = rx[..., sps * stride * m : sps * (stride * m + bl)]
        w, h = (params[k].detach().requires_grad_() for k in ("w", "h"))
        out = ref.butterfly(w, x, sps)
        q = ref.demap(out, st.amps, st.var, st.nu_sc)
        loss, v = ref.elbo(q, x, h, st.amps, st.P)
        gw, gh = torch.autograd.grad(loss.sum(), (w, h))
        params, opt = ref.adam({"w": w.detach(), "h": h.detach()}, opt, {"w": gw, "h": gh},
                               cfg["lr"], step0 + m, lr_half_step)
        var_est.append(v)
        losses.append(loss.detach())
        qs.append(q.detach()[..., crop])
        outs.append(out.detach()[..., crop])
    return (params, opt, torch.stack(var_est, -2), torch.cat(qs, -1), torch.cat(outs, -1),
            torch.stack(losses, -1))


def frame0(cfg: dict, seed: int, runs: int, device, prec: str = "float32",
           params: dict | None = None) -> dict:
    """Frame 0 of an experiment of ``runs`` runs drawn from ``seed``, as
    ``dp_vae.frame0`` gives it, from the Dirac start or from ``params``
    {"w" (R, 2, 4, M), "h" (R, 2, 2, 2, M)}. Returns {"ser" (R, 4), "mi"
    (R, 2), "var_est" (R, 2), "losses" (R, steps)}."""
    with ref.precision(prec), torch.no_grad():
        n_frame, steps, stride, crop, tx_sl, wfn = ref._frame_geometry(cfg)
        st = ref.Setup(cfg, n_frame, device)
        gen = torch.Generator(device=st.device)
        gen.manual_seed(int(seed))
        rx, tx, _ = st.physics(st.theta(0), *st.draws(gen, runs))
        if params is None:
            params = ref.dirac(cfg["m_est"], runs, st.device)
        params = {k: v.to(st.device, torch.float32) for k, v in params.items()}
        with torch.enable_grad():
            _, _, var_est, q, out, losses = train_frame(
                st, params, ref.zero_moments(params), rx, 0, float(cfg["n_lrhalf"]) * steps,
                cfg["batch_len"], stride, crop)
        ser, mi_ = ref.eval_frame(st, q, out, tx[..., tx_sl], wfn)
        return {"ser": ser, "mi": mi_, "var_est": var_est.to(torch.float64).mean(-2).float(),
                "losses": losses}
