"""L0 primitives: constellations + PCS, pulse-shaping filters, stacked-complex
ops (``cplx``) and the entry points' device."""

from .constellation import (
    Constellation,
    demapper_noise_var,
    levels_from_uniform,
    make_constellation,
    mb_prior,
    qam_points,
    sample_levels,
)
from .device import resolve_device
from .filters import rcfir, rrcfir
from . import cplx

__all__ = [
    "Constellation",
    "cplx",
    "demapper_noise_var",
    "levels_from_uniform",
    "make_constellation",
    "mb_prior",
    "qam_points",
    "resolve_device",
    "sample_levels",
    "rcfir",
    "rrcfir",
]
