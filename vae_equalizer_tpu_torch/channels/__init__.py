"""Channel simulators (optical dual-pol) and IR presets."""

from .optical_dp import DpSimulator, make_dp_simulator
from .presets import CHANNEL_PRESETS, channel_ir, upsample_ir

__all__ = ["CHANNEL_PRESETS", "DpSimulator", "channel_ir", "make_dp_simulator", "upsample_ir"]
