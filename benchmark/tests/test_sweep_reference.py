"""The plain reference of a batched SNR sweep (``benchmark/reference/dp_vae_sweep.py``):
one SNR point reads as the plain reference of one experiment at that SNR, and it imports
nothing of the program or of JAX."""

import subprocess
import sys

import numpy as np
import torch

from benchmark.reference import dp_vae as ref
from benchmark.reference import dp_vae_sweep as ref_sweep

from .conftest import ROOT
from .kinds.sweep import SMALL_CONFIG


def test_one_point_is_one_experiment():
    """Frame 0 of a one-point group (its runs at the point's SNR) against
    ``dp_vae.frame0`` of an experiment configured at that SNR, on the same
    seed: the same draws, channel, training and eval, to float32 rounding."""
    from benchmark.harness import core

    torch.set_num_threads(min(4, torch.get_num_threads()))
    cfg = {**core.load_json(core.BENCH / "configs" / "dp_vae_64qam_snr_curve.json"), **SMALL_CONFIG}
    got = ref_sweep.frame0(cfg, 5, [18.0], 2, "cpu")
    want = ref.frame0({**cfg, "snr_db": 18.0}, 5, 2, "cpu")
    np.testing.assert_allclose(got["var_est"].numpy(), want["var_est"].numpy(), rtol=1e-5)
    np.testing.assert_allclose(got["mi"].numpy(), want["mi"].numpy(), atol=1e-4)
    np.testing.assert_allclose(got["ser"].numpy(), want["ser"].numpy(), atol=1e-3)
    var = float(ref.Setup({**cfg, "snr_db": 18.0}, 2000, "cpu").var[0])
    assert got["var"].tolist() == [[var, var]]


def test_sweep_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import benchmark.reference.dp_vae_sweep; "
            "tops = {m.split('.')[0] for m in sys.modules}; "
            "bad = tops & {'vae_equalizer_tpu_torch', 'vae_equalizer_tpu', 'jax', 'jaxlib', "
            "'flax'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
