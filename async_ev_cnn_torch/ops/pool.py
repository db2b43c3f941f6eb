"""Max-pooling ops: the tie-broken argmax of the incremental pool, and the
dense pool of the 'full' layers and the oracle.

Counterpart of ``async_ev_cnn_tpu/ops/pool.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from async_ev_cnn_torch.ops.conv import conv_pads


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


def _pool_identity(dtype: torch.dtype):
    """The max's identity for ``dtype``, the value the JAX op pads with:
    False, -inf, or the integer type's least value."""
    if dtype == torch.bool:
        return False
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def maxpool_dense(
    x: torch.Tensor, ksize: tuple[int, int], stride: int, padding: str = "VALID"
) -> torch.Tensor:
    """Dense max-pool of ``[C, H, W]`` or ``[N, C, H, W]``, float, integer
    or bool (the window-wise OR), with 'VALID' or TF 'SAME' padding.

    SAME pads with the max's identity, as the JAX op's ``reduce_window``
    does.  Floats pool by ``F.max_pool2d`` (cuDNN on the card); integers
    and bool, which it does not take, by a max over unfolded windows."""
    kh, kw = ksize
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    (pt, pb), (pl, pr) = conv_pads(x.shape[-2], x.shape[-1], kh, kw, stride, padding)
    if pt or pb or pl or pr:
        padded = x.new_full((*x.shape[:-2], x.shape[-2] + pt + pb, x.shape[-1] + pl + pr),
                            _pool_identity(x.dtype))
        padded[..., pt:pt + x.shape[-2], pl:pl + x.shape[-1]] = x
        x = padded
    if x.is_floating_point():
        out = F.max_pool2d(x, (kh, kw), stride)
    else:
        out = x.unfold(-2, kh, stride).unfold(-2, kw, stride).amax((-2, -1))
    return out[0] if squeeze else out
