"""Training loops: the DP VAE and VAEflex online frame experiments, the CMA
baselines and the AWGN VAE-LE, VAE-NN and CMA experiments. The LMMSE / DFE
baseline is ``train.dfe.run_lmmse_dfe`` (as in JAX, not exported here)."""

from .awgn import run_cma_awgn, train_vae_le_awgn, train_vae_nn_awgn
from .dp import run_cma_dp, train_vae_dp, train_vae_flex_dp

__all__ = ["run_cma_awgn", "run_cma_dp", "train_vae_dp", "train_vae_flex_dp", "train_vae_le_awgn",
           "train_vae_nn_awgn"]
