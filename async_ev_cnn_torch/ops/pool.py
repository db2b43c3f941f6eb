"""Max-pooling ops: the dense pool of the 'full' layers and the oracle.

Counterpart of ``async_ev_cnn_tpu/ops/pool.py``; ``composite_argmax`` (the
incremental pool's tie-broken argmax) comes with the incremental modes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def maxpool_dense(
    x: torch.Tensor, ksize: tuple[int, int], stride: int, padding: str = "VALID"
) -> torch.Tensor:
    """Dense VALID max-pool of a float ``[C, H, W]`` or ``[N, C, H, W]``."""
    if padding != "VALID":
        raise NotImplementedError(
            f"maxpool_dense supports VALID padding only, got {padding!r}")
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    out = F.max_pool2d(x, tuple(ksize), stride)
    return out[0] if squeeze else out
