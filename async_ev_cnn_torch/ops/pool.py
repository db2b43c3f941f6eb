"""Max-pooling ops: the tie-broken argmax of the incremental pool, and the
dense pool of the 'full' layers and the oracle.

Counterpart of ``async_ev_cnn_tpu/ops/pool.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def composite_argmax(surface_w: torch.Tensor, actfn_w: torch.Tensor):
    """Tie-broken argmax over the last axis.

    Per window: the argmax of the surface, ties broken by the smallest
    conv-actfn value, then by the lowest index.

    Args:
      surface_w: f32 ``[..., K]`` window values to maximise.
      actfn_w:   f32 ``[..., K]`` values that break ties (smaller wins).

    Returns:
      ``(idx, not_argmin)``: int32 ``[...]`` selected index and bool
      ``[...]`` flag, True when the selected position's ``actfn_w`` value
      differs from the window minimum.
    """
    m = surface_w.amax(dim=-1, keepdim=True)
    is_max = surface_w == m
    actfn_at_max = torch.where(is_max, actfn_w, float("inf"))
    a = actfn_at_max.amin(dim=-1, keepdim=True)
    selected = is_max & (actfn_at_max == a)
    # argmax returns the first maximal index; it takes no bool input
    idx = torch.argmax(selected.to(torch.uint8), dim=-1).to(torch.int32)
    not_argmin = a[..., 0] != actfn_w.amin(dim=-1)
    return idx, not_argmin


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
