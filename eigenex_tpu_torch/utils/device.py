"""Device resolution shared by every constructor and front end.

The port's entry points run on the card by default: ``device=None``
means ``"cuda"``.  Tests, and users without a card, pass
``device="cpu"``.  Nothing here falls back: asking for ``"cuda"`` on a
machine without one raises from PyTorch itself.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "as_device_tensor"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA device; anything else -> ``torch.device(device)``."""
    if device is None:
        return torch.device("cuda")
    return torch.device(device)


def as_device_tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays where it lives unless ``device``
    names another place; host data goes to ``device`` (the card unless
    told otherwise)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    return torch.as_tensor(np.asarray(x)).to(resolve_device(device))
