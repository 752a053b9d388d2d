"""Channel simulators (optical dual-pol, AWGN-ISI) and IR presets."""

from .awgn import AwgnSimulator, make_awgn_simulator
from .optical_dp import DpSimulator, make_dp_simulator
from .presets import CHANNEL_PRESETS, channel_ir, upsample_ir

__all__ = ["AwgnSimulator", "CHANNEL_PRESETS", "DpSimulator", "channel_ir", "make_awgn_simulator",
           "make_dp_simulator", "upsample_ir"]
