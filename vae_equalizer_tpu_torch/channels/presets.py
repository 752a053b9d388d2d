"""Channel impulse-response presets (port of ``channels/presets.py``).

``h1``/``h2`` are the ISI test channels of Caciularu & Burshtein as used by
the reference (optical_DP_channel/shared_funcs.py:544-554); ``h0`` is the
identity IR.
"""

from __future__ import annotations

import numpy as np

__all__ = ["CHANNEL_PRESETS", "channel_ir", "upsample_ir"]

CHANNEL_PRESETS = {
    "h0": np.array([1.0 + 0.0j], dtype=np.complex64),
    "h1": np.array(
        [0.0545 + 0.05j, 0.2823 - 0.11971j, -0.7676 + 0.2788j, -0.0641 - 0.0576j, 0.0466 - 0.02275j],
        dtype=np.complex64,
    ),
    "h2": np.array(
        [0.0545 + 0.0165j, -1.3449 - 0.4523j, 1.0067 + 1.1524j, 0.3476 + 0.3153j],
        dtype=np.complex64,
    ),
}


def upsample_ir(h_orig: np.ndarray, sps: int) -> np.ndarray:
    """Zero-insert a symbol-rate IR to ``sps`` samples/symbol and unit-normalize."""
    h = np.zeros(sps * (h_orig.shape[-1] - 1) + 1, dtype=np.complex64)
    h[::sps] = h_orig
    return h / np.linalg.norm(h)


def channel_ir(name: str, sps: int) -> tuple[np.ndarray, int]:
    """Return (upsampled unit-norm IR, number of original symbol-rate taps)."""
    h_orig = CHANNEL_PRESETS[name]
    return upsample_ir(h_orig, sps), h_orig.shape[-1]
