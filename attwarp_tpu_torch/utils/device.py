"""The device an entry point runs on: ``cuda`` unless the caller asks for
the CPU, and never the CPU in silence when the card is missing."""

from __future__ import annotations

import torch


def require_device(device, who: str) -> torch.device:
    """``device`` as a ``torch.device``. A CUDA device where none is present
    raises, naming ``who`` and how to ask for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' "
                           f"(--device cpu) to run on the CPU")
    return device
