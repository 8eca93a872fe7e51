"""Where the port's entry points run."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: the CUDA card unless the caller
    names another (``device="cpu"`` for the CPU). Raises if CUDA is meant and
    no card is present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is present; pass device='cpu' to run on the CPU")
    return device
