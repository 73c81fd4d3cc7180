"""Device resolution shared by every entry point of the port.

Entry points default to ``"cuda"``. Asking for the card on a machine that
has none raises: the port never falls back to the CPU on its own.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` (str or ``torch.device``) -> ``torch.device``; raises
    ``RuntimeError`` for a CUDA device when no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain PyTorch path")
    return dev
