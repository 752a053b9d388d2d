"""Kernel B's run constants and ``stream_bf16``, on its plain version.

Per run, kernel B takes its own lr (R,), demapper variance (R, 2), nu_sc
(R,) and prior P (R, n) (JAX ``vae_dp_frame_train_pallas_rb``,
``frame_kernel.py:767-826, 902-913``). Inputs are made with numpy from a
seed: the plain version with per-run constants is held against JAX's kernel
in interpret mode at a tiny shape (R = 3, 16-QAM, bl 16, M 9, 3 minibatches
across the lr halving), with the tolerances of
``tests/test_torch_frame_kernel.py``; run r of a per-run call against a
shared-constant call with run r's values, and a constant vector against the
shared form, bit for bit; bad shapes; and ``stream_bf16`` against float32.
The CUDA kernel is held to the same in ``chip_smoke.py`` (phase 21).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_equalizer_tpu.ops.frame_kernel import frame_opt_init as j_frame_opt_init
from vae_equalizer_tpu.ops.frame_kernel import vae_dp_frame_train_pallas_rb
from vae_equalizer_tpu_torch.core import demapper_noise_var, make_constellation
from vae_equalizer_tpu_torch.models import butterfly_init, dirac_taps_dp
from vae_equalizer_tpu_torch.ops.frame_kernel import (
    frame_opt_init,
    vae_dp_frame_train,
    vae_dp_frame_train_plain,
)

torch.set_num_threads(1)

M, BL, M_MAX, R = 9, 16, 3, 3
STEP0, LR_HALF = 5, 6.0  # global steps 5, 6, 7: the w lr halves at the second step
NUS = (0.0270955, 0.0, 0.0872449)  # the reference's nu grid values
SNRS = (16.0, 20.0, 23.0)
LRS = (2.5e-3, 1e-3, 3e-3)
NAMES = ("w", "h", "opt", "losses", "var_est", "out", "dec", "eq", "mm", "s1")


def _inputs(seed=17):
    consts = [make_constellation("16-QAM", nu) for nu in NUS]
    rng = np.random.default_rng(seed)
    w = (butterfly_init(M).numpy() + 0.01 * rng.normal(size=(R, 2, 4, M))).astype(np.float32)
    h = (dirac_taps_dp(M).numpy() + 0.01 * rng.normal(size=(R, 2, 2, 2, M))).astype(np.float32)
    rx = (0.5 * rng.normal(size=(R, 2, 2, 2 * BL * M_MAX))).astype(np.float32)
    run = dict(
        lr=np.asarray(LRS, np.float32),
        var=np.asarray([[demapper_noise_var(c, s)] * 2 for c, s in zip(consts, SNRS)], np.float32),
        nu_sc=np.asarray([c.nu_sc for c in consts], np.float32),
        P=np.stack([np.asarray(c.P, np.float32) for c in consts]),
    )
    return consts[0].amps, w, h, rx, run


def _port(w, h, rx, amps, run, sl=slice(None), shared=False, **kw):
    """The port's frame for runs ``sl``; ``shared``: one run's constants in
    their shared form (floats, (2,), (n,))."""
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    wt, ht = T(w[sl]), T(h[sl])
    c = {k: (v[sl][0] if shared else v[sl]) for k, v in run.items()}
    lr, nu = (float(c["lr"]), float(c["nu_sc"])) if shared else (T(c["lr"]), T(c["nu_sc"]))
    res = vae_dp_frame_train(wt, ht, frame_opt_init({"w": wt, "h": ht}), T(rx[sl]), T(amps),
                             T(c["var"]), nu, T(c["P"]), lr, STEP0, LR_HALF, bl_sym=BL, **kw)
    return dict(zip(NAMES, res))


def _flat(res):
    return {**{k: v for k, v in res.items() if k != "opt"}, **res["opt"]}


def test_per_run_plain_matches_jax_kernel():
    amps, w, h, rx, run = _inputs()
    j = {k: jnp.asarray(v) for k, v in run.items()}
    opt = j_frame_opt_init({"w": jnp.asarray(w), "h": jnp.asarray(h)})
    w1, h1, opt1, losses, var_est, q, out, dec, eq, mm, s1 = vae_dp_frame_train_pallas_rb(
        jnp.asarray(w), jnp.asarray(h), opt, jnp.asarray(rx), jnp.asarray(amps), j["var"],
        j["nu_sc"], j["P"], j["lr"], jnp.float32(STEP0), jnp.float32(LR_HALF), bl_sym=BL,
        interpret=True, emit_eval=True, emit_q=False)
    want = {k: np.asarray(v) for k, v in dict(
        w=w1, h=h1, **opt1, losses=losses, var_est=var_est, out=out, eq=eq, mm=mm, s1=s1).items()}
    got = {k: v.numpy() for k, v in _flat(_port(w, h, rx, amps, run)).items()}
    assert got["dec"].dtype == np.int32 and got["losses"].shape == (M_MAX, R)
    # the tolerances of tests/test_torch_frame_kernel.py (f32 rounding of
    # the JAX kernel's folded demapper operands and matmul sums, ~1e-6
    # relative, amplified by 3 Adam steps and the softmin's 1/(2 var) gain)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5)
    np.testing.assert_allclose(got["var_est"], want["var_est"], rtol=2e-5)
    np.testing.assert_allclose(got["out"], want["out"], rtol=1e-4, atol=1e-6)
    for k in ("w", "h"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=3e-7, err_msg=k)
    for k in ("mw", "vw", "mh", "vh"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4 * np.abs(want[k]).max(),
                                   err_msg=k)
    np.testing.assert_allclose(got["mm"], want["mm"], rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(got["s1"], want["s1"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["eq"], want["eq"], rtol=1e-4, atol=1e-4)
    assert np.mean(got["dec"] == np.asarray(dec).astype(np.int32)) > 0.999
    # the runs really differ: each row trained with its own constants
    assert not np.allclose(got["w"][0], got["w"][1], rtol=0, atol=1e-6)


def test_per_run_rows_equal_shared_calls_bit_for_bit():
    amps, w, h, rx, run = _inputs(seed=5)
    per_run = _flat(_port(w, h, rx, amps, run))
    for r in range(R):
        one = _flat(_port(w, h, rx, amps, run, sl=slice(r, r + 1), shared=True))
        for k, v in one.items():
            row = per_run[k][r : r + 1] if k in ("w", "h", "mw", "vw", "mh", "vh") else per_run[k][:, r : r + 1]
            assert torch.equal(row, v), (r, k)
    # constant vectors are the shared form, bit for bit
    const = {k: np.repeat(v[:1], R, axis=0) for k, v in run.items()}
    vec = _flat(_port(w, h, rx, amps, const))
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    wt, ht = T(w), T(h)
    shared = _flat(dict(zip(NAMES, vae_dp_frame_train_plain(
        wt, ht, frame_opt_init({"w": wt, "h": ht}), T(rx), T(amps), T(run["var"][0]),
        float(run["nu_sc"][0]), T(run["P"][0]), float(run["lr"][0]), STEP0, LR_HALF, bl_sym=BL))))
    for k in vec:
        assert torch.equal(vec[k], shared[k]), k


@pytest.mark.parametrize("bad, match", [
    ({"lr": np.zeros(2, np.float32)}, r"per-run lr must have shape \(3,\), got \(2,\)"),
    ({"var": np.ones((4, 2), np.float32)}, r"per-run var must be \(3, 2\), got \(4, 2\)"),
    ({"nu_sc": np.zeros(5, np.float32)}, r"per-run nu_sc must have shape \(3,\), got \(5,\)"),
    ({"P": np.full((2, 4), 0.25, np.float32)}, r"per-run P must have leading dim 3, got \(2, 4\)"),
])
def test_bad_run_constant_shapes_raise(bad, match):
    amps, w, h, rx, run = _inputs()
    with pytest.raises(ValueError, match=match):
        _port(w, h, rx, amps, {**run, **bad})


def test_stream_bf16_plain():
    """stream_bf16 stores out / dec / eq as bfloat16 and changes nothing
    else: training, losses, var_est, mm and s1 are bit-identical; out and eq
    are float32's values rounded to bfloat16 (within 2^-8 relative), dec's
    level indices are exact."""
    amps, w, h, rx, run = _inputs(seed=8)
    f32 = _flat(_port(w, h, rx, amps, run))
    bf = _flat(_port(w, h, rx, amps, run, stream_bf16=True))
    for k in ("out", "dec", "eq"):
        assert bf[k].dtype == torch.bfloat16, k
    for k in ("w", "h", "mw", "vw", "mh", "vh", "losses", "var_est", "mm", "s1"):
        assert bf[k].dtype == torch.float32 and torch.equal(bf[k], f32[k]), k
    assert torch.equal(bf["dec"].to(torch.int32), f32["dec"])
    for k in ("out", "eq"):
        assert torch.equal(bf[k], f32[k].to(torch.bfloat16)), k
        np.testing.assert_allclose(bf[k].float().numpy(), f32[k].numpy(), rtol=2.0**-8, atol=0)
