"""Max-pool layer.

Counterpart of ``async_ev_cnn_tpu/layers/maxpool.py``; this slice runs the
'full' (dense recompute) mode.  The incremental 'event' mode raises
``NotImplementedError`` until its slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from async_ev_cnn_torch.layers.types import LayerIO, PoolState
from async_ev_cnn_torch.ops.masks import pool_out_shape
from async_ev_cnn_torch.ops.pool import maxpool_dense


class PoolSpec(NamedTuple):
    in_shape: tuple[int, int, int]  # (C, H, W) of the previous layer
    ksize: tuple[int, int]
    stride: int
    mode: str = "event"  # 'event' (incremental) | 'full' (dense recompute)
    act_dtype: str = "float32"  # 'full'-mode activation storage (see ConvSpec)

    @property
    def out_shape(self) -> tuple[int, int, int]:
        c, h, w = self.in_shape
        oh, ow = pool_out_shape(h, w, self.ksize, self.stride)
        return (c, oh, ow)


def _require_full(spec: PoolSpec) -> None:
    if spec.mode != "full":
        raise NotImplementedError(
            f"pool mode {spec.mode!r} waits for the port's incremental-mode "
            "slice; this slice runs mode 'full'")


def _full_pool_io(spec: PoolSpec, prev_io: LayerIO) -> LayerIO:
    """Dense max over the *activated* map.  The leaky activation is
    monotone, so this equals the activated value at the window argmax."""
    fm = maxpool_dense(prev_io.featuremap, spec.ksize, spec.stride, "VALID")
    return LayerIO(surface=fm, layer_actfn=None, conv_actfn=None, mask=None)


def pool_init(spec: PoolSpec, prev_init_io: LayerIO) -> tuple[PoolState, LayerIO]:
    """Initial state: 0-dim placeholders in 'full' mode."""
    _require_full(spec)
    dev = prev_init_io.surface.device
    state = PoolState(idx_max=torch.zeros((), dtype=torch.int32, device=dev),
                      recompute=torch.zeros((), dtype=torch.bool, device=dev))
    return state, _full_pool_io(spec, prev_init_io)


def pool_step(spec: PoolSpec, state: PoolState, prev_io: LayerIO, delta_leak
              ) -> tuple[PoolState, LayerIO]:
    _require_full(spec)
    return state, _full_pool_io(spec, prev_io)
