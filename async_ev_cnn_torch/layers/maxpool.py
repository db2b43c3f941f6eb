"""Incremental max-pool layer.

Counterpart of ``async_ev_cnn_tpu/layers/maxpool.py`` (its docstring has the
reference semantics).  State is the within-window argmax index per
``(channel, oy, ox)`` plus the ``recompute`` set, windows whose winner may
be overtaken as leak accumulates.  Per step: clear the event windows from
the recompute set, take the union as the active set, re-run the composite
argmax there, flag unstable windows again, and emit every active window.
The reference's quirk is kept: a recompute window that becomes stable is
not cleared; only an event landing on it clears the flag.  Outputs are
gathers at the stored indices over non-overlapping windows (``stride ==
ksize``).  'full' mode is the dense pool of a 'full' predecessor, and
takes a stride below the size too, with TF 'SAME' padding (darknet's
size-2 stride-1 maxpool).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from async_ev_cnn_torch.layers.types import LayerIO, PoolState
from async_ev_cnn_torch.ops.conv import conv_out_shape
from async_ev_cnn_torch.ops.masks import dilate_mask, window_view
from async_ev_cnn_torch.ops.pool import composite_argmax, maxpool_dense


class PoolSpec(NamedTuple):
    in_shape: tuple[int, int, int]  # (C, H, W) of the previous layer
    ksize: tuple[int, int]
    stride: int
    mode: str = "event"  # 'event' (incremental) | 'full' (dense recompute)
    act_dtype: str = "float32"  # 'full'-mode activation storage (see ConvSpec)

    @property
    def padding(self) -> str:
        """'VALID', or TF 'SAME' (padded with the max's identity) for a
        stride below the window, whose windows overlap ('full' only)."""
        return "SAME" if self.stride < min(self.ksize) else "VALID"

    @property
    def out_shape(self) -> tuple[int, int, int]:
        c, h, w = self.in_shape
        oh, ow = conv_out_shape(h, w, *self.ksize, self.stride, self.padding)
        return (c, oh, ow)


def _full_pool_io(spec: PoolSpec, prev_io: LayerIO) -> LayerIO:
    """Dense max over the *activated* map.  The leaky activation is
    monotone, so this equals the activated value at the window argmax."""
    fm = maxpool_dense(prev_io.featuremap, spec.ksize, spec.stride, spec.padding)
    # a max over bf16 inputs is exact in bf16
    return LayerIO(surface=fm.to(getattr(torch, spec.act_dtype)), layer_actfn=None,
                   conv_actfn=None, mask=None)


def _gather(spec: PoolSpec, array, idx):
    """Pooled view of ``array`` at the stored indices: [C,H,W] -> [C,oh,ow].

    A one-hot select and sum over the window axis, as the JAX package
    computes it (exact: one ``x`` and zeros)."""
    win = window_view(array, spec.ksize, spec.stride)  # [C, oh, ow, kk]
    kk = win.shape[-1]
    onehot = idx[..., None] == torch.arange(kk, dtype=idx.dtype, device=idx.device)
    zero = torch.zeros((), dtype=win.dtype, device=win.device)
    return torch.where(onehot, win, zero).sum(dim=-1)


def _make_io(spec: PoolSpec, prev_io: LayerIO, idx, mask) -> LayerIO:
    return LayerIO(
        surface=_gather(spec, prev_io.surface, idx),
        layer_actfn=_gather(spec, prev_io.layer_actfn, idx),
        conv_actfn=_gather(spec, prev_io.conv_actfn, idx),
        mask=mask,
    )


def pool_init(spec: PoolSpec, prev_init_io: LayerIO) -> tuple[PoolState, LayerIO]:
    """Initial indices: the plain argmax of the initial surface.  'full'
    mode keeps 0-dim placeholders."""
    dev = prev_init_io.surface.device
    if spec.mode == "full":
        state = PoolState(idx_max=torch.zeros((), dtype=torch.int32, device=dev),
                          recompute=torch.zeros((), dtype=torch.bool, device=dev))
        return state, _full_pool_io(spec, prev_init_io)
    surf_w = window_view(prev_init_io.surface, spec.ksize, spec.stride)
    idx = torch.argmax(surf_w, dim=-1).to(torch.int32)
    _, oh, ow = spec.out_shape
    none = torch.zeros((oh, ow), dtype=torch.bool, device=dev)
    state = PoolState(idx_max=idx, recompute=none)
    return state, _make_io(spec, prev_init_io, idx, none.clone())


def pool_step_full_recompute(spec: PoolSpec, state: PoolState, prev_io: LayerIO,
                             delta_leak) -> tuple[PoolState, LayerIO]:
    """Oracle variant: recompute the dense argmax of every window each step
    and emit events where the winning index changed."""
    surf_w = window_view(prev_io.surface, spec.ksize, spec.stride)
    idx = torch.argmax(surf_w, dim=-1).to(torch.int32)
    ev_windows = dilate_mask(prev_io.mask, spec.ksize, spec.stride)
    changed = (idx != state.idx_max).any(dim=0)
    new_state = PoolState(idx_max=idx, recompute=state.recompute)
    return new_state, _make_io(spec, prev_io, idx, ev_windows | changed)


def pool_step(spec: PoolSpec, state: PoolState, prev_io: LayerIO, delta_leak
              ) -> tuple[PoolState, LayerIO]:
    if spec.mode == "full":
        return state, _full_pool_io(spec, prev_io)
    ev_windows = dilate_mask(prev_io.mask, spec.ksize, spec.stride)
    recompute = state.recompute & ~ev_windows  # only events clear the flag
    active = ev_windows | recompute

    surf_w = window_view(prev_io.surface, spec.ksize, spec.stride)
    cact_w = window_view(prev_io.conv_actfn, spec.ksize, spec.stride)
    idx_new, not_argmin_c = composite_argmax(surf_w, cact_w)  # per channel
    not_argmin = not_argmin_c.any(dim=0)

    idx = torch.where(active[None], idx_new, state.idx_max)
    recompute = recompute | (active & not_argmin)
    new_state = PoolState(idx_max=idx, recompute=recompute)
    return new_state, _make_io(spec, prev_io, idx, active)
