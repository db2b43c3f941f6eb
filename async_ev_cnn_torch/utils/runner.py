"""Event-stream packing for the runners.

Counterpart of ``async_ev_cnn_tpu/utils/runner.py``; this slice carries
:func:`pack_chunks`, which the parallel-in-time path and the tests feed
from.  The runner classes come with the CLI slice.
"""

from __future__ import annotations

import numpy as np
import torch

from async_ev_cnn_torch.layers.types import EventChunk, validate_int32_ts
from async_ev_cnn_torch.utils.device import resolve_device


def pack_chunks(events: np.ndarray, capacity: int, device=None) -> EventChunk:
    """Pack an ``[N, >=3]`` (y, x, ts[, p]) stream into stacked padded
    chunks ``[T, capacity]`` on ``device``.  Polarity is carried when the
    4th column is present; timestamps go through the int32 contract
    checks."""
    dev = resolve_device(device)
    n = events.shape[0]
    validate_int32_ts(events[:, 2] if n else np.zeros(0, np.int32))
    t = max(1, int(np.ceil(n / capacity)))
    pad = t * capacity - n

    def column(i):
        col = np.concatenate([events[:, i], np.zeros(pad, events.dtype)])
        return torch.from_numpy(col.astype(np.int32).reshape(t, capacity)).to(dev)

    p = column(3) if events.shape[1] > 3 else torch.zeros(
        (t, capacity), dtype=torch.int32, device=dev)
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    return EventChunk(
        y=column(0), x=column(1), ts=column(2), p=p,
        valid=torch.from_numpy(valid.reshape(t, capacity)).to(dev),
    )
