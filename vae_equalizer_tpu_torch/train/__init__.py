"""Training loops: the DP VAE online frame experiment."""

from .dp import train_vae_dp

__all__ = ["train_vae_dp"]
