"""Device resolution shared by every constructor and front end.

The port's entry points run on the card by default: ``device=None``
means ``"cuda"``.  Tests, and users without a card, pass
``device="cpu"``.  Nothing here falls back: asking for ``"cuda"`` on a
machine without one raises from PyTorch itself.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA device; anything else -> ``torch.device(device)``."""
    if device is None:
        return torch.device("cuda")
    return torch.device(device)
