"""Training loops: the DP VAE and VAEflex online frame experiments, the CMA
baselines and the AWGN VAE-LE and VAE-NN experiments."""

from .awgn import train_vae_le_awgn, train_vae_nn_awgn
from .dp import run_cma_dp, train_vae_dp, train_vae_flex_dp

__all__ = ["run_cma_dp", "train_vae_dp", "train_vae_flex_dp", "train_vae_le_awgn", "train_vae_nn_awgn"]
