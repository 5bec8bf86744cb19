"""Explicit device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``torch.device(device)``; a CUDA device must really exist.

    The port never inspects availability to quietly pick the CPU: the
    default is the card, and a machine without one gets an error that says
    how to ask for the CPU explicitly.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain PyTorch versions "
            f"on the host")
    return dev
