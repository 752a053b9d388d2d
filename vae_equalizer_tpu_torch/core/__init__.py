"""L0 primitives: constellations + PCS and pulse-shaping filters."""

from .constellation import (
    Constellation,
    demapper_noise_var,
    levels_from_uniform,
    make_constellation,
    mb_prior,
    qam_points,
    sample_levels,
)
from .filters import rcfir, rrcfir

__all__ = [
    "Constellation",
    "demapper_noise_var",
    "levels_from_uniform",
    "make_constellation",
    "mb_prior",
    "qam_points",
    "sample_levels",
    "rcfir",
    "rrcfir",
]
