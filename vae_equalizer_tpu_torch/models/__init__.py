"""Equalizer models and the ELBO (the DP VAE-LE and CMA paths, the AWGN
VAE-LE, VAE-NN and CMA, the LMMSE / DFE baseline). The streaming DP receiver is ``models.streaming``
(it runs kernel E of ``ops``, so the package does not import it)."""

from .cma import cma_batch_dp, cma_dp, cma_flex_dp, cma_siso, dirac_taps_dp, dirac_taps_siso
from .losses import elbo_dp, elbo_siso, posterior_moments
from .vae_le import (
    VaeLeDp,
    butterfly_apply,
    butterfly_init,
    siso_fir_init,
    soft_demap_dp,
    vae_le_dp_forward,
    vae_le_siso_forward,
)
from .vae_nn import vae_nn_forward, vae_nn_init
from .lmmse_dfe import (  # noqa: I001 (last: it imports ops, whose kernels import the modules above)
    complex_fir,
    compute_feedback,
    compute_feedforward,
    compute_lmmse,
    dfe_equalize,
    nearest_neighbor,
)

__all__ = [
    "VaeLeDp",
    "butterfly_apply",
    "butterfly_init",
    "cma_batch_dp",
    "cma_dp",
    "cma_flex_dp",
    "cma_siso",
    "complex_fir",
    "compute_feedback",
    "compute_feedforward",
    "compute_lmmse",
    "dfe_equalize",
    "dirac_taps_dp",
    "dirac_taps_siso",
    "elbo_dp",
    "elbo_siso",
    "nearest_neighbor",
    "posterior_moments",
    "siso_fir_init",
    "soft_demap_dp",
    "vae_le_dp_forward",
    "vae_le_siso_forward",
    "vae_nn_forward",
    "vae_nn_init",
]
