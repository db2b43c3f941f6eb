"""Active-site mask algebra.

Counterpart of ``async_ev_cnn_tpu/ops/masks.py``.  Only the pool output
shape is on the 'full'-mode path; the mask dilation, window view and
rulebook coordinates come with the incremental modes.
"""

from __future__ import annotations


def pool_out_shape(in_h: int, in_w: int, ksize: tuple[int, int], stride: int):
    """VALID pooling output shape."""
    return (in_h - ksize[0]) // stride + 1, (in_w - ksize[1]) // stride + 1
