"""Leaky-surface integration of event chunks.

Counterpart of ``async_ev_cnn_tpu/ops/integrate.py`` (the reference
semantics are in its docstring): two sequential clamps — leak-subtract then
clamp at zero, event-add then clamp at zero; within a chunk the last
duplicate of a pixel wins, which with non-decreasing timestamps is the
(ts, index)-lexicographic maximum; every rounded product goes through
``snap``.  The port is bit-exact to the JAX package.
"""

from __future__ import annotations

import torch

from async_ev_cnn_torch.ops.numerics import float32_scalar, snap
from async_ev_cnn_torch.ops.surface_scan import (
    TS_SENTINEL_VALUE,
    surface_scan_events,
    surface_scan_tsmap,
)


def _i32(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.int32, device=device)


def _event_ts_map(y, x, ts, valid, h: int, w: int) -> torch.Tensor:
    """Per-pixel max timestamp of the chunk's events; sentinel elsewhere.

    The JAX package computes it as an O(H*W*E) broadcast compare and max,
    because a scatter serializes on the TPU; here it is a scatter-amax on
    the flat pixel index, which gives the same per-pixel maximum.  Invalid
    events scatter the sentinel (a no-op under amax) to pixel 0, so the op
    needs no host-side compaction."""
    pix = y.long() * w + x.long()
    ok = valid & (pix >= 0) & (pix < h * w)
    sentinel = _i32(TS_SENTINEL_VALUE, ts.device)
    ts_map = torch.full((h * w,), TS_SENTINEL_VALUE, dtype=torch.int32,
                        device=ts.device)
    ts_map.scatter_reduce_(0, torch.where(ok, pix, 0),
                           torch.where(ok, ts.to(torch.int32), sentinel), "amax")
    return ts_map.reshape(h, w)


def integrate_step(surface, prev_ts, y, x, ts, valid, leak: float, p=None):
    """One chunk of leaky integration.

    Args:
      surface: f32 ``[H, W]`` or ``[2, H, W]`` (polarity-channel) surface.
      prev_ts: int32 scalar, timestamp of the previous chunk's last event.
      y, x, ts, valid: padded chunk tensors ``[E]``.
      leak: leak rate per microsecond.
      p: int32 ``[E]`` polarities — required for a ``[C, H, W]`` surface;
        OFF events (p == 0) land in channel 0, ON in channel 1.

    Returns:
      ``(new_surface, last_ts, out_mask, delta_leak)`` as in the JAX
      package: ``out_mask`` is the bool ``[H, W]`` event mask this layer
      emits, ``delta_leak`` the f32 scalar leak applied.
    """
    channeled = surface.dim() == 3
    if channeled and p is None:
        raise TypeError(
            "a [C, H, W] channeled surface requires the polarity array p")
    dev = surface.device
    h, w = surface.shape[-2:]
    leak_f = float32_scalar(leak, dev)
    prev_ts = _i32(prev_ts, dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sentinel = _i32(TS_SENTINEL_VALUE, dev)
    # an all-padding chunk is a no-op step: last_ts falls back to prev_ts
    last_ts = torch.maximum(prev_ts, torch.where(valid, ts.to(torch.int32),
                                                 sentinel).max())
    delta_leak = snap((last_ts - prev_ts).float() * leak_f)

    before_pos = surface > 0
    s1 = surface - delta_leak
    after_leak_neg = s1 <= 0
    s1 = torch.where(after_leak_neg, zero, s1)

    if channeled:
        ts_map = torch.stack([
            _event_ts_map(y, x, ts, valid & (p == ch), h, w)
            for ch in range(surface.shape[0])
        ])
    else:
        ts_map = _event_ts_map(y, x, ts, valid, h, w)
    ev_mask = ts_map > TS_SENTINEL_VALUE
    contrib = 1 - snap((last_ts - ts_map).float() * leak_f)
    s2 = s1 + torch.where(ev_mask, contrib, zero)
    after_ev_neg = s2 <= 0
    s2 = torch.where(after_ev_neg, zero, s2)

    out_mask = (before_pos & (after_leak_neg | after_ev_neg)) | ev_mask
    if channeled:
        out_mask = out_mask.any(dim=0)
    return s2, last_ts, out_mask, delta_leak


def _ts_chain(prev_ts, chunks, leak):
    """Per-chunk running last-event timestamps and snapped leak decrements.

    Returns ``(last_ts [T] int32, d [T] f32)``.  All-padding chunks keep
    the previous last_ts, making them exact identity updates.
    """
    dev = chunks.ts.device
    prev_ts = _i32(prev_ts, dev)
    chunk_max = torch.where(chunks.valid, chunks.ts.to(torch.int32),
                            _i32(TS_SENTINEL_VALUE, dev)).amax(dim=1)
    last_ts = torch.cummax(torch.maximum(chunk_max, prev_ts), dim=0).values
    prev_last = torch.cat([prev_ts.reshape(1), last_ts[:-1]])
    d = snap((last_ts - prev_last).float() * float32_scalar(leak, dev))
    return last_ts, d


def chunk_event_updates(channels, h, w, prev_ts, chunks, leak):
    """O(E) per-event update lists for :func:`surface_scan_events`.

    * The in-chunk winner per pixel: no later (ts, index)-lexicographic
      valid event at the same pixel — the same O(T*E^2) rule as the JAX
      package, hence the same winners.
    * Each winner's flat ``C*H*W`` pixel index (``-1`` for losers and
      padding).  The JAX package splits it into the TPU kernel's 128-lane
      (row, lane) pair; the CUDA kernel takes the flat index.
    * ``dt = last_ts[t] - ts`` (int32, in [0, 2^31) for non-negative int32
      timestamps; 0 for non-winners).

    Returns ``(pix, dt, d, last_ts)``: int32 ``[T, E]`` event tensors and
    the ``[T]`` scalar chains.
    """
    last_ts, d = _ts_chain(prev_ts, chunks, leak)
    dev = chunks.ts.device
    yi = chunks.y.to(torch.int32)
    xi = chunks.x.to(torch.int32)
    if channels == 1:
        ch = torch.zeros_like(yi)
        valid = chunks.valid
    else:
        p = chunks.p.to(torch.int32)
        ch = p.clamp(0, channels - 1)
        valid = chunks.valid & (p >= 0) & (p < channels)
    minus_one = _i32(-1, dev)
    pix = torch.where(valid, ch * (h * w) + yi * w + xi, minus_one)  # [T, E]

    ts_b = torch.where(valid, chunks.ts.to(torch.int32),
                       _i32(TS_SENTINEL_VALUE, dev))
    idx = torch.arange(pix.shape[1], device=dev)
    same = (pix[:, :, None] == pix[:, None, :]) & valid[:, None, :]
    later = (ts_b[:, None, :] > ts_b[:, :, None]) | (
        (ts_b[:, None, :] == ts_b[:, :, None])
        & (idx[None, None, :] > idx[None, :, None])
    )
    keep = valid & ~(same & later).any(dim=2)  # [T, E]

    pix = torch.where(keep, pix, minus_one)
    dt = torch.where(keep, last_ts[:, None] - ts_b, _i32(0, dev))
    return pix, dt, d, last_ts


def chunk_ts_maps(channels, h, w, prev_ts, chunks, leak):
    """Per-chunk timestamp maps and leak decrements.

    Returns ``(ts_map, d, last_ts)``: int32 ``[T, C, H, W]`` per-pixel max
    event timestamps (sentinel where a chunk has no event at that pixel),
    f32 ``[T]`` snapped leak decrements and int32 ``[T]`` running last-event
    timestamps.  The full map only; the bounding-window variant
    (``ts_window``) comes with a later slice.
    """
    last_ts, d = _ts_chain(prev_ts, chunks, leak)
    dev = chunks.ts.device
    t = chunks.y.shape[0]
    pix = chunks.y.long() * w + chunks.x.long()
    ok = chunks.valid & (pix >= 0) & (pix < h * w)
    if channels == 1:
        ch = torch.zeros_like(pix)
    else:
        # valid & (p == ch) for ch in range(channels), as in the JAX package
        ch = chunks.p.long()
        ok = ok & (ch >= 0) & (ch < channels)
    plane = channels * h * w
    flat = torch.arange(t, device=dev)[:, None] * plane + ch * (h * w) + pix
    ts_map = torch.full((t * plane,), TS_SENTINEL_VALUE, dtype=torch.int32,
                        device=dev)
    ts_map.scatter_reduce_(
        0, torch.where(ok, flat, 0).reshape(-1),
        torch.where(ok, chunks.ts.to(torch.int32),
                    _i32(TS_SENTINEL_VALUE, dev)).reshape(-1),
        "amax")
    return ts_map.reshape(t, channels, h, w), d, last_ts


def integrate_parallel(surface, prev_ts, chunks, leak: float,
                       engine: str = "auto"):
    """All ``T`` chunk-boundary surfaces at once (parallel-in-time).

    Engines (the JAX package's names in brackets):

    * ``'events'`` (JAX ``'pallas'``): the winner lists of
      :func:`chunk_event_updates` placed by :func:`surface_scan_events`;
      no ``[T, C, H, W]`` ts map is materialized.
    * ``'tsmap'`` (JAX ``'pallas_tsmap'``): the maps of
      :func:`chunk_ts_maps` streamed through :func:`surface_scan_tsmap`;
      the cross-check of the 'events' engine.
    * ``'auto'`` is ``'events'``.

    Both are bit-identical to iterating :func:`integrate_step`.  The JAX
    package's max-plus ``'xla'`` engine comes with the time-shard slice.

    Args:
      surface: f32 ``[C, H, W]`` surface at the window start.
      prev_ts: int32 scalar, last event timestamp before the window.
      chunks: stacked :class:`EventChunk` with leading time axis ``[T, E]``.
      leak: leak rate per microsecond.

    Returns:
      ``(surfaces, last_ts)``: f32 ``[T, C, H, W]`` surfaces after each
      chunk and the int32 ``[T]`` per-chunk last-event timestamps.
    """
    channels, h, w = surface.shape
    if engine in ("auto", "events"):
        pix, dt, d, last_ts = chunk_event_updates(
            channels, h, w, prev_ts, chunks, leak)
        return surface_scan_events(surface.contiguous(), pix, dt, d, leak), last_ts
    if engine == "tsmap":
        ts_map, d, last_ts = chunk_ts_maps(channels, h, w, prev_ts, chunks, leak)
        return surface_scan_tsmap(surface.contiguous(), ts_map, d, last_ts,
                                  leak), last_ts
    raise ValueError(
        f"engine must be 'auto', 'events' or 'tsmap', got {engine!r}")
