"""The port's device rule: public entry points run on the card unless the
caller asks for the CPU, and never drop to the CPU on their own."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``device`` as a ``torch.device``, ``cuda`` when None; raises when a
    CUDA device is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for {dev}; pass device='cpu' to run on the CPU")
    return dev
