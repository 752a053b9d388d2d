"""Evaluation metrics of the DP VAE path: sync, SER and MI."""

from .mi import mutual_information_ambiguity_mb_stats
from .ser import ser_constell_shaping, ser_iqflip_from_dec
from .sync import find_shift_symb_dp

__all__ = [
    "find_shift_symb_dp",
    "mutual_information_ambiguity_mb_stats",
    "ser_constell_shaping",
    "ser_iqflip_from_dec",
]
