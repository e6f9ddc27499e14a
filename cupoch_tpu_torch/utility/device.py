"""Device selection for the port's entry points.

Entry points run on the card unless the caller names another device.
With no device named and no card present they raise: they never fall
back to the CPU on their own.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a `torch.device`; None means "cuda", which must be
    available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
