"""The plain reference against the port's plain CPU path at a small size,
and the reference's independence from the program."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.reference import dp_vae as ref

from .conftest import ROOT
from .kinds.experiment import SMALL_CONFIG


def _cfg(loss_type: str, **kw):
    from vae_equalizer_tpu_torch.utils import DpConfig

    pcfg = DpConfig(loss_type=loss_type, **{**SMALL_CONFIG, **kw})
    cfg = dataclasses.asdict(pcfg)
    cfg["phi_iq"] = list(cfg["phi_iq"])
    return pcfg, cfg


@pytest.mark.parametrize("loss_type", ["VAE", "VAEflex"])
@pytest.mark.parametrize("mode", [False, "frame"])
def test_frame0_matches_the_program(loss_type, mode):
    """Frame 0 of an experiment (draws, channel, training, eval) by the
    reference against the runner's plain CPU path: the autograd mode to
    float32 rounding, kernel B's plain version (another closed-form
    gradient) to the rounding 20 Adam steps amplify."""
    from vae_equalizer_tpu_torch.train import train_vae_dp, train_vae_flex_dp

    # 20 steps (VAE) or 90 windows (VAEflex): under the ~150 steps at which
    # two float32 roundings part
    pcfg, cfg = _cfg(loss_type, n_frame_max=2000 if loss_type == "VAE" else 1000)
    fn = train_vae_dp if loss_type == "VAE" else train_vae_flex_dp
    torch.set_num_threads(min(4, torch.get_num_threads()))
    res = fn(pcfg, 77, device="cpu", runs=2, use_pallas=mode)
    want = ref.frame0(cfg, 77, 2, "cpu")
    tol = 1e-5 if mode is False else 2e-3
    np.testing.assert_allclose(res["var_est"][..., 0], want["var_est"].numpy(), rtol=tol)
    np.testing.assert_allclose(res["mi"][..., 0], want["mi"].numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(res["ser"][..., 0], want["ser"].numpy(), atol=tol)


def test_stream_block_matches_the_receiver():
    """Three blocks of the streaming receiver (route B's plain version and
    kernel E's on the CPU) against the reference from the same states."""
    from vae_equalizer_tpu_torch.models.streaming import StreamingReceiver

    cfg = _cfg("VAE")[1]
    st = ref.Setup(cfg, 2000, "cpu")
    gen = torch.Generator().manual_seed(3)
    blocks = torch.randn((3, 2, 2, 4000), generator=gen) * 0.3
    rxr = StreamingReceiver(st.amps, st.P, st.var, st.nu_sc, block_len=2000, use_pallas=True,
                            device="cpu")
    state = rxr.init()
    for b in range(3):
        flat = {**state["params"], **{k: state["opt"][k] for k in ("mw", "vw", "mh", "vh")},
                "step": state["opt"]["step"], "tail": state["tail"]}
        new_ref, q_ref, out_ref = ref.stream_block(st, flat, blocks[b], 100)
        state, q, out = rxr.step(state, blocks[b])
        torch.testing.assert_close(out, out_ref, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(q, q_ref, rtol=1e-3, atol=1e-4)
        torch.testing.assert_close(state["params"]["w"], new_ref["w"], rtol=1e-4, atol=1e-6)
        assert state["opt"]["step"] == new_ref["step"] == 20 * (b + 1)


def test_eval_params_separates_trained_from_untrained():
    """The final-butterfly check reads a trained equalizer low and the
    Dirac start high on the configuration's channel (12 frames of 10,000
    symbols, no drift: the training settles by frame ~9)."""
    from vae_equalizer_tpu_torch.train import train_vae_dp

    pcfg, cfg = _cfg("VAE", num_frames=12, n_frame_max=10000, theta_diff=0.0)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    res = train_vae_dp(pcfg, 5, device="cpu", runs=1, use_pallas="frame")
    trained = ref.eval_params(cfg, res["params"]["w"], 9, 11).mean(-1)
    dirac = ref.eval_params(cfg, ref.dirac(25, 1, "cpu")["w"], 9, 11).mean(-1)
    assert float(trained.max()) < 0.05 < 0.5 < float(dirac.min())


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import benchmark.reference.dp_vae; "
            "tops = {m.split('.')[0] for m in sys.modules}; "
            "bad = tops & {'vae_equalizer_tpu_torch', 'vae_equalizer_tpu', 'jax', 'jaxlib', 'flax'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
