"""The device of an entry point: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises when it names CUDA and no card is present
    (an entry point never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r}: no CUDA device is available "
                           "(torch.cuda.is_available() is False); pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return dev
