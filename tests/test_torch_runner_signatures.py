"""The port's runners take the JAX runners' parameters in JAX's order.

Each port runner's parameter names equal its JAX counterpart's with the
seed in the key's place, ``device`` inserted third and the port's own
parameters last, so a positional call written for JAX binds the same
arguments (the AWGN runners once passed ``mesh`` as ``use_pallas``).
"""

import inspect

import pytest

import vae_equalizer_tpu.parallel.seqpar as jseqpar
import vae_equalizer_tpu.train as jtrain
import vae_equalizer_tpu.train.dfe as jdfe
import vae_equalizer_tpu_torch.parallel.seqpar as pseqpar
import vae_equalizer_tpu_torch.train as ptrain
import vae_equalizer_tpu_torch.train.dfe as pdfe

# runner -> the port's own parameters, after JAX's
PORT_ONLY = {
    "train_vae_le_awgn": ["draws"],
    "train_vae_nn_awgn": ["params_init", "draws"],
    "train_vae_dp": ["draws", "frame0_losses"],
    "train_vae_flex_dp": ["draws", "frame0_losses"],
    "run_cma_dp": ["draws"],
    "run_cma_awgn": ["draws"],
    "run_lmmse_dfe": ["draws"],
    "train_vae_dp_sharded": ["draws"],
    "train_vae_flex_dp_sharded": ["draws"],
}
# runners outside the train packages' exports (JAX keeps run_lmmse_dfe in train/dfe.py only)
MODULES = {"run_lmmse_dfe": (jdfe, pdfe), "train_vae_dp_sharded": (jseqpar, pseqpar),
           "train_vae_flex_dp_sharded": (jseqpar, pseqpar)}


def _jax_names(jmod, runner) -> list:
    """JAX's parameter names; its ``train_vae_flex_dp_sharded(cfg, key,
    **kwargs)`` passes on ``train_vae_dp_sharded``'s, less flex_windows."""
    if runner == "train_vae_flex_dp_sharded":
        names = _jax_names(jmod, "train_vae_dp_sharded")
        return [n for n in names if n != "flex_windows"]
    return list(inspect.signature(getattr(jmod, runner)).parameters)


@pytest.mark.parametrize("runner", sorted(PORT_ONLY))
def test_runner_takes_jax_argument_order(runner):
    jmod, pmod = MODULES.get(runner, (jtrain, ptrain))
    jax_names = _jax_names(jmod, runner)
    port_names = list(inspect.signature(getattr(pmod, runner)).parameters)
    assert jax_names[:2] == ["cfg", "key"]
    assert port_names == ["cfg", "seed", "device", *jax_names[2:], *PORT_ONLY[runner]]
