"""Training loops: the DP VAE online frame experiment and the CMA baselines."""

from .dp import run_cma_dp, train_vae_dp

__all__ = ["run_cma_dp", "train_vae_dp"]
