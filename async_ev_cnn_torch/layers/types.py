"""Core state types shared by the event-layer runtime.

Counterpart of ``async_ev_cnn_tpu/layers/types.py``: the same ``NamedTuple``
field names, holding torch tensors.  An event micro-batch is a
fixed-capacity padded chunk; inter-layer "events" are dense boolean
active-site masks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from async_ev_cnn_torch.utils.device import resolve_device
from async_ev_cnn_torch.utils.profiling import span


def validate_int32_ts(ts) -> np.ndarray:
    """Enforce the NON-NEGATIVE int32 µs timestamp contract and return the
    int32 array.  A negative or wrapped ts makes ``dt = last_ts - ts``
    exceed 2^31, which the surface-scan kernels' int32 ``dt`` cannot
    carry.  Copied from the JAX package (host numpy, framework-free)."""
    ts_in = np.asarray(ts)
    if ts_in.size:
        lo = int(ts_in.min())
        hi = int(ts_in.max()) if ts_in.dtype != np.int32 else 0
        info = np.iinfo(np.int32)
        if lo < info.min or hi > info.max:
            raise ValueError(
                f"timestamps [{lo}, {hi}] exceed the int32 µs contract "
                "(~35.8 min); rebase the recording (subtract the first "
                "timestamp) before chunking"
            )
        if lo < 0:
            raise ValueError(
                f"negative timestamp {lo}: rebase the recording "
                "(subtract the first timestamp) before chunking"
            )
    return ts_in.astype(np.int32)


class EventChunk(NamedTuple):
    """A fixed-capacity micro-batch of DVS events (``[E]``, or ``[T, E]``
    stacked along a leading time axis).

    Attributes:
      y, x: int32 pixel coordinates.
      ts:   int32 timestamps (microseconds), non-decreasing over the stream.
      p:    int32 polarity (routes events to channel 0/1 of a 2-channel
            surface; ignored by a 1-channel one).
      valid: bool — True for real events, False for padding.
    """

    y: torch.Tensor
    x: torch.Tensor
    ts: torch.Tensor
    p: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return int(self.y.shape[-1])

    @staticmethod
    def from_arrays(y, x, ts, p=None, capacity: int | None = None,
                    device=None) -> "EventChunk":
        """Builds a padded chunk on ``device`` from variable-length host
        arrays; raises on timestamps outside the int32 µs contract.  On the
        card each of its five copies comes from pageable memory, so each
        waits for the card's stream."""
        dev = resolve_device(device)
        with span("chunk.upload"):
            y = np.asarray(y, np.int32)
            x = np.asarray(x, np.int32)
            ts = validate_int32_ts(ts)
            p = np.zeros_like(y) if p is None else np.asarray(p, np.int32)
            n = y.shape[0]
            cap = n if capacity is None else capacity
            if n > cap:
                raise ValueError(f"chunk of {n} events exceeds capacity {cap}")
            pad = cap - n
            valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])

            def _up(a):
                t = torch.from_numpy(a)
                if dev.type != "cuda":
                    return t.to(dev)
                with span("host.sync"):
                    return t.to(dev)

            def _pad(a):
                return _up(np.concatenate([a, np.zeros(pad, a.dtype)]))

            return EventChunk(y=_pad(y), x=_pad(x), ts=_pad(ts), p=_pad(p),
                              valid=_up(valid))


class LayerIO(NamedTuple):
    """What one event layer exposes to the next after its update.

    Attributes:
      surface:     f32 ``[C, H, W]`` (or ``[N, C, H, W]``) pre-activation map.
      layer_actfn: f32 multiplicative activation mask of this layer, or
            ``None`` for a 'full' layer, whose ``surface`` already holds the
            activated map (the JAX package stores a scalar 1 there; ``x * 1``
            is exact, so ``None`` gives the same featuremap without an
            elementwise pass over a whole batch of frames).
      conv_actfn:  f32 cumulative linearisation up to this layer, or ``None``
            for a 'full' layer (nothing downstream of one reads it).
      mask:        bool ``[H, W]`` active sites, or ``None`` for a 'full'
            layer (every site is active).
    """

    surface: torch.Tensor
    layer_actfn: torch.Tensor | None
    conv_actfn: torch.Tensor | None
    mask: torch.Tensor | None

    @property
    def featuremap(self) -> torch.Tensor:
        """``surface * layer_actfn``."""
        if self.layer_actfn is None:
            return self.surface
        return self.surface * self.layer_actfn


class IntegrationState(NamedTuple):
    """State of the leaky-surface input layer."""

    surface: torch.Tensor  # f32 [C, H, W]
    prev_ts: torch.Tensor  # int32 scalar


class ConvState(NamedTuple):
    """State of a conv layer (0-dim placeholders in 'full' mode)."""

    featuremap: torch.Tensor
    conv_actfn: torch.Tensor


class PoolState(NamedTuple):
    """State of a max-pool layer (0-dim placeholders in 'full' mode)."""

    idx_max: torch.Tensor
    recompute: torch.Tensor


class LstmState(NamedTuple):
    """State of a recurrent layer (RVT's ConvLSTM): the hidden and cell
    maps ``[C, H, W]`` carried from one chunk-boundary surface to the
    next."""

    h: torch.Tensor
    c: torch.Tensor
