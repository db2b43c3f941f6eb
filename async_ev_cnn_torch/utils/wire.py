"""Host->device wire format for event upload: the plain 8 B/event tier.

Counterpart of ``async_ev_cnn_tpu/utils/wire.py``.  The packer is host
numpy, copied; the unpack runs in torch on the device, so the expanded
``[T, E]`` planes never cross the link:

* ``yx``     int32 ``[T, E]`` — ``(y << 16) | x``
* ``ts``     int32 ``[T, E]`` — timestamps (µs, the int32 contract)
* ``counts`` int32 ``[T]``    — valid events per chunk

With ``keep_polarity`` the polarity rides bit 31 of the packed word
(``y < 2**15`` then).  The sub-plain tiers (compact, ultra, ultra4) come
with a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from async_ev_cnn_torch.layers.types import EventChunk, validate_int32_ts


def _polarity_col(events: np.ndarray) -> np.ndarray:
    """The p column as strict {0, 1} int32."""
    if events.shape[1] < 4:
        raise ValueError(
            "keep_polarity needs a 4th (polarity) event column"
        )
    p = np.asarray(events[:, 3], np.int32)
    if p.size and (p.min() < 0 or p.max() > 1):
        raise ValueError(
            f"polarity must be 0/1 for the wire (got [{p.min()}, "
            f"{p.max()}]); map {{-1, 1}} conventions to {{0, 1}} first"
        )
    return p


def pack_wire(events: np.ndarray, capacity: int, keep_polarity: bool = False):
    """Pack a host ``[N, >=3]`` (y, x, ts[, p]) stream for upload.

    Returns numpy ``(yx [T, capacity] int32, ts [T, capacity] int32,
    counts [T] int32)``.  Requires ``0 <= y, x < 2**16`` (``y < 2**15``
    under ``keep_polarity``) and timestamps inside the non-negative int32
    µs contract.  Copied from the JAX package.
    """
    n = events.shape[0]
    t = max(1, -(-n // capacity))
    pad = t * capacity - n
    y = np.asarray(events[:, 0], np.int32)
    x = np.asarray(events[:, 1], np.int32)
    ts = validate_int32_ts(events[:, 2])
    y_cap = 2**15 if keep_polarity else 2**16
    if n and (y.min() < 0 or x.min() < 0 or y.max() >= y_cap or x.max() >= 2**16):
        raise ValueError(
            f"pack_wire needs 0 <= y < {y_cap} (bit 31 carries polarity "
            "under keep_polarity) and 0 <= x < 2**16"
        )
    # pack via int64 then truncate: for y >= 2**15 (or a polarity bit)
    # the packed word has the int32 sign bit set (the unpack masks it back)
    packed64 = (y.astype(np.int64) << 16) | x.astype(np.int64)
    if keep_polarity:
        packed64 |= _polarity_col(events).astype(np.int64) << 31
    packed = packed64.astype(np.uint32).view(np.int32)
    yx = np.concatenate([packed, np.zeros(pad, np.int32)])
    tsp = np.concatenate([ts, np.zeros(pad, np.int32)])
    counts = np.full(t, capacity, np.int32)
    counts[-1] = capacity - pad if n else 0
    return yx.reshape(t, capacity), tsp.reshape(t, capacity), counts


def chunks_from_wire(yx: torch.Tensor, ts: torch.Tensor, counts: torch.Tensor,
                     polarity: bool = False) -> EventChunk:
    """Expand the wire triple (int32 tensors on the device) into an
    :class:`EventChunk` on the same device.

    ``polarity`` must match the packer's ``keep_polarity``: bit 31 is
    polarity there and y's top bit otherwise, which the wire itself cannot
    tell apart.
    """
    valid = torch.arange(yx.shape[-1], device=yx.device) < counts[..., None]
    return EventChunk(
        # the masks make the arithmetic shift logical: for y >= 2**15 (or a
        # polarity bit) the packed word is negative and >> sign-extends
        y=(yx >> 16) & (0x7FFF if polarity else 0xFFFF),
        x=yx & 0xFFFF,
        ts=ts,
        p=(yx >> 31) & 1 if polarity else torch.zeros_like(yx),
        valid=valid,
    )
