"""Device resolution for the port's entry points.

The port runs on the card: an entry point given no device takes ``cuda``
and raises where there is none, instead of carrying on quietly on the CPU
(a CPU run is a different measurement, never a fallback).  Tests and
CPU comparisons pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``cuda``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU"
        )
    return torch.device("cuda")
