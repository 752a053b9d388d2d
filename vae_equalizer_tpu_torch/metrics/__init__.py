"""Evaluation metrics of the DP and AWGN paths: CPE, sync, SER and MI."""

from .cpe import cpe_dp, cpe_siso
from .mi import (
    mutual_information,
    mutual_information_ambiguity,
    mutual_information_ambiguity_mb_stats,
)
from .ser import (
    ser_const_siso,
    ser_constell_shaping,
    ser_iqflip,
    ser_iqflip_from_dec,
    ser_q_siso,
    ser_symb_siso,
)
from .sync import (
    expectation_i,
    find_shift_dp,
    find_shift_siso,
    find_shift_symb_dp,
    find_shift_symb_siso,
)

__all__ = [
    "cpe_dp",
    "cpe_siso",
    "expectation_i",
    "find_shift_dp",
    "find_shift_siso",
    "find_shift_symb_dp",
    "find_shift_symb_siso",
    "mutual_information",
    "mutual_information_ambiguity",
    "mutual_information_ambiguity_mb_stats",
    "ser_const_siso",
    "ser_constell_shaping",
    "ser_iqflip",
    "ser_iqflip_from_dec",
    "ser_q_siso",
    "ser_symb_siso",
]
