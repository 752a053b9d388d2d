"""Equalizer models and the ELBO (the DP VAE-LE and CMA paths)."""

from .cma import cma_batch_dp, cma_dp, cma_flex_dp, dirac_taps_dp
from .losses import elbo_dp, posterior_moments
from .vae_le import VaeLeDp, butterfly_apply, butterfly_init, soft_demap_dp, vae_le_dp_forward

__all__ = [
    "VaeLeDp",
    "butterfly_apply",
    "butterfly_init",
    "cma_batch_dp",
    "cma_dp",
    "cma_flex_dp",
    "dirac_taps_dp",
    "elbo_dp",
    "posterior_moments",
    "soft_demap_dp",
    "vae_le_dp_forward",
]
