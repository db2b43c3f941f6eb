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

from async_ev_cnn_torch.layers.types import EventChunk
from async_ev_cnn_torch.ops.numerics import float32_scalar, snap
from async_ev_cnn_torch.ops.surface_scan import (
    TS_SENTINEL_VALUE,
    surface_scan_events,
    surface_scan_tsmap,
)
from async_ev_cnn_torch.utils.device import resolve_device


def _i32(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.int32, device=device)


# Constants enter the arithmetic as Python scalars or 0-dim CPU tensors
# (float32_scalar(..., "cpu")), never as tensors made on the card: making one
# is a pageable host-to-device copy, which waits for the card's stream.


def _event_ts_map(y, x, ts, valid, h: int, w: int) -> torch.Tensor:
    """Per-pixel max timestamp of the chunk's events; sentinel elsewhere.

    The JAX package computes it as an O(H*W*E) broadcast compare and max,
    because a scatter serializes on the TPU; here it is a scatter-amax on
    the flat pixel index, which gives the same per-pixel maximum.  Invalid
    events scatter the sentinel (a no-op under amax) to pixel 0, so the op
    needs no host-side compaction."""
    pix = y.long() * w + x.long()
    ok = valid & (pix >= 0) & (pix < h * w)
    ts_map = torch.full((h * w,), TS_SENTINEL_VALUE, dtype=torch.int32,
                        device=ts.device)
    ts_map.scatter_reduce_(0, torch.where(ok, pix, 0),
                           torch.where(ok, ts.to(torch.int32), TS_SENTINEL_VALUE),
                           "amax")
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
    leak_f = float32_scalar(leak, "cpu")
    prev_ts = _i32(prev_ts, dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    # an all-padding chunk is a no-op step: last_ts falls back to prev_ts
    last_ts = torch.maximum(prev_ts, torch.where(valid, ts.to(torch.int32),
                                                 TS_SENTINEL_VALUE).max())
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

    Returns ``(last_ts [T] int32, d [T] f32)``, or ``[S, T]`` for chunks
    ``[S, T, E]`` and ``prev_ts`` ``[S]`` (the stream axis).  All-padding
    chunks keep the previous last_ts, making them exact identity updates.
    """
    dev = chunks.ts.device
    prev_ts = _i32(prev_ts, dev)[..., None]  # [(S,) 1]
    chunk_max = torch.where(chunks.valid, chunks.ts.to(torch.int32),
                            TS_SENTINEL_VALUE).amax(dim=-1)
    last_ts = torch.cummax(torch.maximum(chunk_max, prev_ts), dim=-1).values
    prev_last = torch.cat([prev_ts, last_ts[..., :-1]], dim=-1)
    d = snap((last_ts - prev_last).float() * float32_scalar(leak, "cpu"))
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
    the ``[T]`` scalar chains.  With a leading stream axis (chunks ``[S, T,
    E]``, ``prev_ts`` ``[S]``) every output gains it, each stream equal to
    a call of its own (the JAX package's ``vmap``).
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
    pix = torch.where(valid, ch * (h * w) + yi * w + xi, -1)  # [(S,) T, E]

    ts_b = torch.where(valid, chunks.ts.to(torch.int32), TS_SENTINEL_VALUE)
    idx = torch.arange(pix.shape[-1], device=dev)
    same = (pix[..., :, None] == pix[..., None, :]) & valid[..., None, :]
    later = (ts_b[..., None, :] > ts_b[..., :, None]) | (
        (ts_b[..., None, :] == ts_b[..., :, None])
        & (idx[None, :] > idx[:, None])
    )
    keep = valid & ~(same & later).any(dim=-1)  # [(S,) T, E]

    pix = torch.where(keep, pix, -1)
    dt = torch.where(keep, last_ts[..., None] - ts_b, 0)
    return pix, dt, d, last_ts


def chunk_ts_maps(channels, h, w, prev_ts, chunks, leak, ts_window=None):
    """Per-chunk timestamp maps and leak decrements.

    Returns ``(ts_map, d, last_ts)``: int32 ``[T, C, H, W]`` per-pixel max
    event timestamps (sentinel where a chunk has no event at that pixel),
    f32 ``[T]`` snapped leak decrements and int32 ``[T]`` running last-event
    timestamps.

    ``ts_window`` (``(wh, ww)``) is accepted for the JAX package's
    signature and computes nothing differently.  There it bounds each
    chunk's O(H*W*E) compare-reduce to a window around the chunk's events,
    falling back to the full compare when a chunk overflows, and gives the
    same maps bit for bit either way.  Here the maps come from one O(T*E)
    ``scatter_reduce``, which has no per-pixel compare to shrink, so the
    window would add work and change nothing.
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
        torch.where(ok, chunks.ts.to(torch.int32), TS_SENTINEL_VALUE).reshape(-1),
        "amax")
    return ts_map.reshape(t, channels, h, w), d, last_ts


def chunk_affine_updates(channels, h, w, prev_ts, chunks, leak, ts_window=None):
    """Per-chunk max-plus coefficients of the leaky-surface update.

    Returns ``(b, c, last_ts)``: f32 ``[T, C, H, W]`` pairs such that chunk
    t's surface update is ``s -> max(s + b[t], c[t])``, and the int32
    ``[T]`` running last-event timestamps.  Every rounded product goes
    through ``snap`` as on the sequential path.  The 'maxplus' engine of
    :func:`integrate_parallel` scans them; the pairs also compose across
    devices (the JAX package's time shard)."""
    ts_map, d, last_ts = chunk_ts_maps(channels, h, w, prev_ts, chunks, leak,
                                       ts_window=ts_window)
    ev_mask = ts_map > TS_SENTINEL_VALUE
    lt = last_ts[:, None, None, None]
    contrib = 1 - snap((lt - ts_map).float() * float32_scalar(leak, "cpu"))
    a = torch.where(ev_mask, contrib, torch.zeros((), dtype=torch.float32,
                                                  device=contrib.device))
    b = a - d[:, None, None, None]
    c = torch.clamp_min(a, 0.0)
    return b, c, last_ts


def maxplus_combine(left, right):
    """Composition of max-plus affine maps ``g[b, c](s) = max(s + b, c)``:
    ``right`` applied after ``left``."""
    bl, cl = left
    br, cr = right
    return bl + br, torch.maximum(cl + br, cr)


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a[0], b[0], a[1], b[1], ...`` along axis 0 (``len(a)`` is
    ``len(b)`` or one more)."""
    out = torch.empty((a.shape[0] + b.shape[0], *a.shape[1:]), dtype=a.dtype,
                      device=a.device)
    out[0::2] = a
    out[1::2] = b
    return out


def associative_scan(fn, elems: tuple) -> tuple:
    """Inclusive prefix scan of the associative ``fn`` over axis 0 of the
    tensors in ``elems``, with ``jax.lax.associative_scan``'s grouping:
    combine adjacent pairs, scan the half-length result recursively (the
    odd outputs), then combine each odd output with the next even input
    (the even outputs), and interleave.  ``fn`` takes and returns tuples
    like ``elems``.  For floating-point ``fn`` the grouping decides the
    roundings, so the same grouping gives the JAX package's bits."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn(tuple(e[0:-1:2] for e in elems), tuple(e[1::2] for e in elems))
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    even = tuple(torch.cat([e[:1], r]) for e, r in zip(elems, even))
    return tuple(_interleave(a, b) for a, b in zip(even, odd))


def integrate_parallel(surface, prev_ts, chunks, leak: float,
                       ts_window: tuple[int, int] | None = None,
                       engine: str = "auto"):
    """All ``T`` chunk-boundary surfaces at once (parallel-in-time).

    Engines (the JAX package's names in brackets):

    * ``'events'`` (JAX ``'pallas'``): the winner lists of
      :func:`chunk_event_updates` placed by :func:`surface_scan_events`;
      no ``[T, C, H, W]`` ts map is materialized.
    * ``'tsmap'`` (JAX ``'pallas_tsmap'``): the maps of
      :func:`chunk_ts_maps` streamed through :func:`surface_scan_tsmap`;
      the cross-check of the 'events' engine.
    * ``'maxplus'`` (JAX ``'xla'``): the per-chunk update
      ``f(s) = max(max(s - d, 0) + a, 0)`` is the max-plus affine map
      ``g[b, c](s) = max(s + b, c)`` with ``b = a - d``, ``c = max(a, 0)``
      (:func:`chunk_affine_updates`), closed under composition
      (:func:`maxplus_combine`), so one :func:`associative_scan` over the
      ``(b, c)`` pairs gives every surface.  Plain torch ops; the grouping
      is JAX's, so it matches the JAX ``'xla'`` engine bit for bit, and
      the other engines to the snap grid up to the regrouping (~1 ulp).
    * ``'auto'`` is ``'events'``.

    'events' and 'tsmap' are bit-identical to iterating
    :func:`integrate_step`.

    Args:
      surface: f32 ``[C, H, W]`` surface at the window start, or ``[S, C,
        H, W]`` with a leading stream axis (multi-stream serving; the JAX
        package ``vmap``s this function over it).
      prev_ts: int32 scalar (``[S]``), last event timestamp before the window.
      chunks: stacked :class:`EventChunk` with leading time axis ``[T, E]``
        (``[S, T, E]``).
      leak: leak rate per microsecond.
      ts_window: optional ``(wh, ww)``, the JAX package's bounding window
        of the ts maps; the 'events' engine ignores it, as there, and the
        others compute the same maps with or without it
        (:func:`chunk_ts_maps`).
      engine: ``'auto' | 'events' | 'tsmap' | 'maxplus'``.  With the stream
        axis 'events' places every stream's winners in one call of K1 (its
        stream axis); 'tsmap' and 'maxplus' run stream by stream.

    Returns:
      ``(surfaces, last_ts)``: f32 ``[T, C, H, W]`` surfaces after each
      chunk and the int32 ``[T]`` per-chunk last-event timestamps (``[S, T,
      C, H, W]`` and ``[S, T]`` with the stream axis), each stream equal to
      a call of its own.
    """
    if surface.dim() == 4 and engine not in ("auto", "events"):
        prev = _i32(prev_ts, surface.device)
        runs = [integrate_parallel(surface[i], prev[i], EventChunk(*(f[i] for f in chunks)),
                                   leak, ts_window=ts_window, engine=engine)
                for i in range(surface.shape[0])]
        return torch.stack([r[0] for r in runs]), torch.stack([r[1] for r in runs])
    channels, h, w = surface.shape[-3:]
    if engine in ("auto", "events"):
        pix, dt, d, last_ts = chunk_event_updates(
            channels, h, w, prev_ts, chunks, leak)
        return surface_scan_events(surface.contiguous(), pix, dt, d, leak), last_ts
    if engine == "tsmap":
        ts_map, d, last_ts = chunk_ts_maps(channels, h, w, prev_ts, chunks, leak,
                                           ts_window=ts_window)
        return surface_scan_tsmap(surface.contiguous(), ts_map, d, last_ts,
                                  leak), last_ts
    if engine == "maxplus":
        b, c, last_ts = chunk_affine_updates(channels, h, w, prev_ts, chunks, leak,
                                             ts_window=ts_window)
        big_b, big_c = associative_scan(maxplus_combine, (b, c))
        return torch.maximum(surface[None] + big_b, big_c), last_ts
    raise ValueError(
        f"engine must be 'auto', 'events', 'tsmap' or 'maxplus', got {engine!r}")


# ---- frame integration (the frame models' input) -----------------------------


def _integrate_frame(frame, prev_ts, y, x, ts, leak: float, h: int, w: int):
    """One slice of :func:`integrate_frame`: the JAX package's
    ``_integrate_frame_jit``, with its strict ``< 0`` clamps kept as
    ``where`` (a ``clamp`` would turn -0.0 into +0.0)."""
    zero = torch.zeros((), dtype=torch.float32, device=frame.device)
    leak_f = float32_scalar(leak, "cpu")
    last_ts = torch.maximum(prev_ts, ts.max())
    f1 = frame - snap((last_ts - prev_ts).float() * leak_f)
    f1 = torch.where(f1 < 0, zero, f1)
    ts_map = _event_ts_map(y, x, ts, torch.ones_like(ts, dtype=torch.bool), h, w)
    ev_mask = ts_map > TS_SENTINEL_VALUE
    contrib = 1 - snap((last_ts - ts_map).float() * leak_f)
    f2 = f1 + torch.where(ev_mask, contrib, zero)
    f2 = torch.where(f2 < 0, zero, f2)
    return f2, last_ts


def integrate_frame(events, leak, frame_h, frame_w, prev_output=None, device=None):
    """Stateless-in/out frame accumulator, the frame models' input.

    The JAX package's ``integrate_frame`` (the reference's viz.py
    accumulator): ``events`` is ``[N, 3]`` rows of ``(y, x, ts)`` (a numpy
    array or a tensor); returns ``(frame [H, W] f32, last_ts int32)`` on
    ``device`` (``cuda`` when not given).  ``prev_output`` is the previous
    call's return: chaining one call per chunk is the reference's
    per-micro-batch protocol.  Within a call the last duplicate of a pixel
    wins.  An empty ``events`` returns ``prev_output`` unchanged (no time
    advances, nothing lands).  Bit-exact to the JAX package.
    """
    dev = resolve_device(device)
    if prev_output is None:
        frame = torch.zeros((frame_h, frame_w), dtype=torch.float32, device=dev)
        prev_ts = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        frame, prev_ts = prev_output
        frame = torch.as_tensor(frame, dtype=torch.float32, device=dev)
        prev_ts = torch.as_tensor(prev_ts, dtype=torch.int32, device=dev)
    events = torch.as_tensor(events, device=dev)
    if events.shape[0] == 0:
        return frame, prev_ts
    y, x, ts = (events[:, i].to(torch.int32) for i in range(3))
    return _integrate_frame(frame, prev_ts, y, x, ts, leak, frame_h, frame_w)


def integrate_frame_chunked(events, leak, frame_h, frame_w, prev_output=None,
                            slice_len=2048, device=None):
    """:func:`integrate_frame` over fixed-size event slices, chained: the
    same value as one :func:`integrate_frame` call per slice, as in the JAX
    package.  A ragged last slice is padded by repeating its final event,
    which changes no pixel's winner within the slice (the JAX package pads
    so that one compiled program serves every stream length; the port
    keeps the padding so the two agree on what a slice is)."""
    dev = resolve_device(device)
    events = torch.as_tensor(events, device=dev)
    n = events.shape[0]
    if n == 0:
        return integrate_frame(events, leak, frame_h, frame_w, prev_output, dev)
    out = prev_output
    for i in range(0, n, slice_len):
        sl = events[i:i + slice_len]
        if sl.shape[0] < slice_len:
            sl = torch.cat([sl, sl[-1:].expand(slice_len - sl.shape[0], -1)])
        out = integrate_frame(sl, leak, frame_h, frame_w, out, dev)
    return out
