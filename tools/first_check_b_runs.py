"""A short first check of kernel B's run constants and stream_bf16 on the
card, before chip_smoke.py.

Builds every kernel library; runs chip_smoke's phase 21 (kernel B with
per-run lr / var / nu_sc / P against its plain version, constant vectors and
rows against the shared form bit for bit, stream_bf16 against float32) from
a state warmed by 20 frames; with ``--parent DIR``, a checkout of the
previous commit, it also builds that checkout's dp library and holds
kernels A and B of this tree to it, bit for bit, on shared-constant calls
at the flagship shapes (R = 8, DpConfig(): one 10,000-symbol frame, 100
minibatches). Run from the repository root on a machine with a card:
``python tools/first_check_b_runs.py [--parent DIR]``.
"""

import argparse
import dataclasses
import importlib.util
import pathlib
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke
from vae_equalizer_tpu_torch.models import butterfly_init, dirac_taps_dp
from vae_equalizer_tpu_torch.ops import _build
from vae_equalizer_tpu_torch.ops.elbo_kernel import vae_dp_loss_and_grad
from vae_equalizer_tpu_torch.ops.frame_kernel import frame_opt_init, vae_dp_frame_train
from vae_equalizer_tpu_torch.train import dp as train_dp
from vae_equalizer_tpu_torch.utils import DpConfig


def parent_matches(parent: pathlib.Path, f_args, a_args, bl: int) -> list:
    """Kernels A and B of the parent checkout against this tree's, shared
    constants: the names of the outputs that differ in any bit."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", parent / "vae_equalizer_tpu_torch" / "ops" / "_build.py")
    pb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pb)
    lib = pb.load()
    w, h, opt, rx, amps, var, nu_sc, P, lr, step0, thresh = f_args
    R, m, n_lev, n_total = w.shape[0], w.shape[-1], amps.shape[0], rx.shape[-1]
    m_max = n_total // (2 * bl)
    new = vae_dp_frame_train(*f_args, bl_sym=bl)
    old = [torch.empty_like(t) for t in (w, h, opt["mw"], opt["vw"], opt["mh"], opt["vh"])]
    old += [torch.empty_like(t) for t in new[3:5]] + [torch.empty_like(t) for t in new[5:]]
    ins = (rx, w, h, opt["mw"], opt["vw"], opt["mh"], opt["vh"])
    rc = lib.vae_dp_frame_launch(R, m_max, bl, bl, m, n_lev, n_total, *(t.data_ptr() for t in ins + tuple(old)),
                                 amps.data_ptr(), P.data_ptr(), var.data_ptr(), nu_sc, lr, step0, thresh,
                                 pb.stream(rx.device))
    pb.check(rc, "parent vae_dp_frame_launch")
    new_flat = [new[0], new[1], *(new[2][k] for k in ("mw", "vw", "mh", "vh")), *new[3:]]
    names = ["w", "h", "mw", "vw", "mh", "vh", "losses", "var_est", "out", "dec", "eq", "mm", "s1"]
    bad = [n for n, a, b in zip(names, new_flat, old) if not torch.equal(a, b)]
    w0, h0, x, amps, var, nu_sc, P = a_args
    got = vae_dp_loss_and_grad(*a_args)
    outs = [torch.empty_like(t) for t in (torch.empty(R, 3, device=x.device), *got[2:])]
    rc = lib.vae_dp_step_launch(R, x.data_ptr(), x.stride(0), x.stride(-2),
                                *(t.data_ptr() for t in (w0, h0, amps, P, var)), nu_sc, x.shape[-1] // 2,
                                m, n_lev, *(t.data_ptr() for t in outs), pb.stream(x.device))
    pb.check(rc, "parent vae_dp_step_launch")
    torch.cuda.synchronize()
    bad += [f"A {n}" for n, a, b in zip(("loss", "var_est"), got[:2], (outs[0][:, 0], outs[0][:, 1:3]))
            if not torch.equal(a, b)]
    bad += [f"A {n}" for n, a, b in zip(("gw", "gh", "q", "out"), got[2:], outs[1:]) if not torch.equal(a, b)]
    return bad


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, secs, log = _build.build()
    print(f"build {secs:.1f} s;", " | ".join(ln.strip() for ln in log.splitlines()
                                            if "vae_dp_frame" in ln or "registers" in ln)[:2000], flush=True)
    dev = torch.device("cuda")
    cfg = DpConfig()
    m_max = cfg.n_frame_max // cfg.batch_len
    const, var, sim, amps, P = train_dp._setup(cfg, m_max * cfg.batch_len, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    R, M, bl = 8, cfg.m_est, cfg.batch_len
    rng = torch.Generator(device=dev)
    rng.manual_seed(99)
    w0 = butterfly_init(M, dev) + 0.01 * torch.randn((R, 2, 4, M), generator=rng, device=dev)
    h0 = dirac_taps_dp(M, dev) + 0.01 * torch.randn((R, 2, 2, 2, M), generator=rng, device=dev)
    thetas = train_dp._frame_inputs(dataclasses.replace(cfg, num_frames=21), dev)
    wk = butterfly_init(M, dev).expand(R, 2, 4, M).contiguous()
    hk = dirac_taps_dp(M, dev).expand(R, 2, 2, 2, M).contiguous()
    optk, thresh = frame_opt_init({"w": wk, "h": hk}), float(cfg.n_lrhalf * m_max)
    for f in range(20):
        wk, hk, optk = vae_dp_frame_train(wk, hk, optk, sim(gen, thetas[f], R)[0], amps, var, const.nu_sc,
                                          P, cfg.lr, f * m_max, thresh, bl_sym=bl)[:3]
    f_args = (wk, hk, optk, sim(gen, thetas[20], R)[0], amps, var, const.nu_sc, P, cfg.lr, 20 * m_max,
              thresh)
    t0 = time.perf_counter()
    res = chip_smoke._per_run_phase("first check", cfg, sim, gen, w0, h0, const, amps, P, f_args)
    print(f"phase 21: {time.perf_counter() - t0:.1f} s, {res}", flush=True)
    if args.parent is not None:
        a_args = (w0, h0, f_args[3][..., 2 * bl : 4 * bl], amps, var, const.nu_sc, P)
        bad = parent_matches(args.parent, f_args, a_args, bl)
        print(f"parent {args.parent}: kernels A and B bit for bit: {not bad} {bad}", flush=True)
        if bad:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
