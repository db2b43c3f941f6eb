"""Host->device wire formats for event upload: four exact tiers.

Counterpart of ``async_ev_cnn_tpu/utils/wire.py`` (its docstring has the
design).  The packers, the tier classifier and the host re-encoders are
host numpy, copied byte for byte; the unpacks run in torch on the device,
so the expanded ``[T, E]`` planes never cross the link.  The tiers, each
applying when the stream's statistics allow and falling back to the next
(``StreamingPipeline(wire='auto')``):

* **ultra4** (2.5 B/event): u16 ``(y << 8) | x`` + two 4-bit per-event
  ts deltas a byte (little-endian nibbles) — coords < 256, within-chunk
  gaps < 16 µs;
* **ultra** (3 B/event): u16 yx + u8 per-event ts deltas — gaps < 256 µs;
* **compact** (4 B/event): u16 yx + u16 ts deltas against a per-chunk
  int32 base — chunk spans < 65.5 ms;
* **plain** (8 B/event): int32 ``(y << 16) | x`` + int32 ts + counts.

Every sub-plain tuple is ``(yx, ts plane, base [T], counts [T])`` plus,
with ``keep_polarity``, a little-endian bit-packed polarity plane (1 bit
an event); the plain triple carries polarity in bit 31 of the packed
word.  Leading axes broadcast through the unpacks, so a stacked ``[S,
...]`` multi-stream group decodes in one call.

torch has few ``uint16`` ops, so a u16 plane is uploaded as its int16
view (:func:`wire_to_device`) and the unpacks widen every narrow plane to
int32 (masking the sign extension off) before they shift; cumsums are
taken in int32 (``torch.cumsum`` of int32 gives int64 unless told).
"""

from __future__ import annotations

import numpy as np
import torch

from async_ev_cnn_torch.layers.types import EventChunk, validate_int32_ts
from async_ev_cnn_torch.utils.profiling import span


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


def _pack_subplain(events, capacity, keep_polarity, ts_encoder,
                   empty_ts_plane):
    """Shared scaffolding of the three sub-plain packers (compact /
    ultra / ultra4): empty-stream tuple, the <256 coordinate gate, the
    padded ``[T, E]`` ts matrix, counts, and the optional bit-packed
    polarity plane.  Only the ts-delta encoding differs per tier —
    ``ts_encoder(tsp) -> (ts_plane, base) | None`` (None: stream does
    not fit the tier; the int64 wrap guards live in the encoders) and
    ``empty_ts_plane`` the tier's ``[1, w]`` zero plane for ``n == 0``.
    A change to the shared parts lands in every tier at once."""
    n = events.shape[0]
    t = max(1, -(-n // capacity))
    pad = t * capacity - n
    y = np.asarray(events[:, 0], np.int32)
    x = np.asarray(events[:, 1], np.int32)
    ts = validate_int32_ts(events[:, 2])
    pol_bytes = -(-capacity // 8)
    if n == 0:
        empty = (np.zeros((1, capacity), np.uint16), empty_ts_plane,
                 np.zeros(1, np.int32), np.zeros(1, np.int32))
        return empty + ((np.zeros((1, pol_bytes), np.uint8),)
                        if keep_polarity else ())
    if y.min() < 0 or x.min() < 0 or y.max() >= 256 or x.max() >= 256:
        return None
    tsp = np.concatenate([ts, np.full(pad, ts[-1], np.int32)]).reshape(
        t, capacity)
    enc = ts_encoder(tsp)
    if enc is None:
        return None
    ts_plane, base = enc
    yxp = np.concatenate(
        [(y << 8) | x, np.zeros(pad, np.int32)]
    ).reshape(t, capacity)
    counts = np.full(t, capacity, np.int32)
    counts[-1] = capacity - pad
    out = (yxp.astype(np.uint16), ts_plane, base.astype(np.int32), counts)
    if keep_polarity:
        p = _polarity_col(events)
        bits = np.concatenate([p, np.zeros(pad, np.int32)]).reshape(
            t, capacity).astype(bool)
        out += (np.packbits(bits, axis=1, bitorder="little"),)
    return out


def pack_wire_compact(events: np.ndarray, capacity: int,
                      keep_polarity: bool = False):
    """4 bytes/event wire: uint16 ``(y << 8) | x`` + uint16 ts deltas
    against a per-chunk int32 base.

    Applicable when every coordinate fits 8 bits (frames < 256 on each
    axis — the eFCN's 160x224 does) and every chunk's timestamp span fits
    16 bits (spans < 65.5 ms; count-packed DVS chunks are typically a few
    ms).  Returns ``(yx u16 [T, E], dts u16 [T, E], base i32 [T],
    counts i32 [T])`` or ``None`` when the stream does not fit — callers
    fall back to :func:`pack_wire` (8 B/event).  Exact: the device
    reconstructs ``ts = base + dts`` in int32.  Timestamps are validated
    against the non-negative int32 µs contract (a wrapped ts would
    silently corrupt the event-scatter engine downstream).

    With ``keep_polarity`` a fifth array is appended: ``pol`` uint8
    ``[T, ceil(capacity/8)]``, the little-endian bit-packed polarity
    plane (1 bit/event) — unpack with :func:`chunks_from_wire_compact`'s
    five-argument form.
    """
    def encode(tsp):
        base = tsp.min(axis=1)
        # int64 diff: an int32 subtraction could wrap for adversarial
        # spans (> 2**31) and sneak past the gate below
        dts = tsp.astype(np.int64) - base[:, None]
        if dts.max() >= 2**16:
            return None
        return dts.astype(np.uint16), base

    return _pack_subplain(events, capacity, keep_polarity, encode,
                          np.zeros((1, capacity), np.uint16))


def pack_wire_ultra(events: np.ndarray, capacity: int,
                    keep_polarity: bool = False):
    """3 bytes/event wire: uint16 ``(y << 8) | x`` + uint8 per-event ts
    deltas against the previous event (the chunk's first event against a
    per-chunk int32 base, so its delta is 0).

    Applicable when every coordinate fits 8 bits, timestamps are
    non-decreasing within each chunk, every within-chunk inter-event gap
    is < 256 µs, and each chunk's total span fits 16 bits (so the tuple
    always converts exactly to the compact tier; automatic for
    ``capacity <= 257``).  Busy event streams — the regime where the
    host->device link binds — satisfy the gap bound by construction:
    count-packed chunks at high rates have µs-scale gaps.  Returns
    ``(yx u16 [T, E], d8 u8 [T, E], base i32 [T], counts i32 [T])`` or
    ``None`` when the stream does not fit — callers fall back to
    :func:`pack_wire_compact` (4 B/event).  Exact: the device
    reconstructs ``ts = base + cumsum(d8)`` in int32.

    With ``keep_polarity`` the same bit-packed polarity plane as the
    compact tier is appended (``pol`` uint8 ``[T, ceil(capacity/8)]``).
    """
    def encode(tsp):
        base = tsp[:, 0]
        # int64 diffs: adversarial int32-spanning gaps must not wrap
        # past the gates below (same guard as the compact packer)
        d = np.diff(tsp.astype(np.int64), axis=1, prepend=base[:, None])
        if d.min() < 0 or d.max() >= 256 or d.sum(axis=1).max() >= 2**16:
            return None
        return d.astype(np.uint8), base

    return _pack_subplain(events, capacity, keep_polarity, encode,
                          np.zeros((1, capacity), np.uint8))


def pack_wire_ultra4(events: np.ndarray, capacity: int,
                     keep_polarity: bool = False):
    """2.5 bytes/event wire: uint16 ``(y << 8) | x`` + two 4-bit
    per-event ts deltas per byte (little-endian nibbles) against the
    previous event (the chunk's first event against a per-chunk int32
    base, so its delta is 0).

    Applicable when every coordinate fits 8 bits, timestamps are
    non-decreasing within each chunk, and every within-chunk inter-event
    gap is < 16 µs — the very-busy-stream regime (>~62.5k ev/s sustained
    inside a chunk's span) that is exactly where the host->device link
    binds and bytes/event set the pipe's ceiling.  The span gate of the
    wider tiers holds automatically for ``capacity <= 4369`` (15 µs max
    gap x capacity < 2**16) but is still checked, so the tuple always
    converts exactly up the ladder.  Returns ``(yx u16 [T, E], d4 u8
    [T, ceil(E/2)], base i32 [T], counts i32 [T])`` or ``None`` when the
    stream does not fit — callers fall back to :func:`pack_wire_ultra`
    (3 B/event).  ``capacity < 2`` also returns ``None``: there the d4
    plane's width would equal the yx plane's and :func:`wire_format`
    could not tell the tier from ultra.  Exact: the device expands the
    nibbles and reconstructs ``ts = base + cumsum(d)`` in int32.

    With ``keep_polarity`` the same bit-packed polarity plane as the
    other sub-plain tiers is appended (``pol`` u8 ``[T, ceil(cap/8)]``).
    """
    if capacity < 2:
        return None

    def encode(tsp):
        base = tsp[:, 0]
        # int64 diffs: adversarial int32-spanning gaps must not wrap
        # past the gates below (same guard as the wider packers)
        d = np.diff(tsp.astype(np.int64), axis=1, prepend=base[:, None])
        if d.min() < 0 or d.max() >= 16 or d.sum(axis=1).max() >= 2**16:
            return None
        d8 = d.astype(np.uint8)
        if capacity % 2:
            d8 = np.concatenate(
                [d8, np.zeros((len(d8), 1), np.uint8)], axis=1)
        return d8[:, 0::2] | (d8[:, 1::2] << 4), base

    half = -(-capacity // 2)
    return _pack_subplain(events, capacity, keep_polarity, encode,
                          np.zeros((1, half), np.uint8))


def wire_format(w) -> str:
    """Classify a wire tuple by shape+dtype sniffing — 'plain' (3 arrays),
    'compact' (u16 second plane), 'ultra' (u8 second plane, full width)
    or 'ultra4' (u8 second plane at HALF the yx plane's width — two
    4-bit deltas per byte; the packer refuses capacity < 2, where the
    widths would coincide).  The tier ORDER matters to callers unifying
    mixed groups: each tier converts exactly to the next
    (``WIRE_TIERS`` ranks them)."""
    if len(w) == 3:
        return "plain"
    if w[1].dtype == np.uint16:
        return "compact"
    return "ultra4" if w[1].shape[-1] != w[0].shape[-1] else "ultra"


#: tier name -> rank; higher rank = more general (unification target)
WIRE_TIERS = {"ultra4": 0, "ultra": 1, "compact": 2, "plain": 3}


def wire_ultra_to_compact(w):
    """Re-encode an ultra wire tuple as the compact tier on the host —
    exact (``dts = cumsum(d8)`` fits u16 by the ultra packer's span
    gate; the polarity plane is shared verbatim)."""
    yx16, d8, base, counts = w[:4]
    dts = np.cumsum(d8.astype(np.int32), axis=1)
    return (yx16, dts.astype(np.uint16), base, counts) + tuple(w[4:])


def wire_ultra4_to_ultra(w):
    """Re-encode an ultra4 wire tuple as the ultra tier on the host —
    exact (little-endian nibble expansion back to one u8 delta per
    event; the polarity plane is shared verbatim)."""
    yx16, d4, base, counts = w[:4]
    cap = yx16.shape[-1]
    lo = d4 & 0xF
    hi = d4 >> 4
    d8 = np.stack([lo, hi], axis=-1).reshape(*d4.shape[:-1], -1)[..., :cap]
    return (yx16, np.ascontiguousarray(d8), base, counts) + tuple(w[4:])


def wire_to_tier(w, tier: str):
    """Upconvert a wire tuple to ``tier`` (exact, host-side; a tuple
    already at or above the target is returned unchanged)."""
    if WIRE_TIERS[wire_format(w)] >= WIRE_TIERS[tier]:
        return w
    if wire_format(w) == "ultra4":
        w = wire_ultra4_to_ultra(w)
    if WIRE_TIERS[wire_format(w)] >= WIRE_TIERS[tier]:
        return w
    if wire_format(w) == "ultra":
        w = wire_ultra_to_compact(w)
    if tier == "plain" and wire_format(w) == "compact":
        w = wire_compact_to_plain(w)
    return w


def wire_compact_to_plain(w):
    """Re-encode a compact wire tuple (quadruple, or quintuple with the
    polarity plane) as the plain 8 B triple on the host — exact
    (``ts = base + dts`` in int32, coordinates < 256 fit the 16-bit
    fields trivially; a polarity plane moves to the plain word's bit 31).
    Lets a consumer unify a pre-packed group whose members chose
    different formats without the raw events."""
    yx16, dts, base, counts = w[:4]
    y = (yx16.astype(np.int32) >> 8) & 0xFF
    x = yx16.astype(np.int32) & 0xFF
    yx = (y << 16) | x
    if len(w) == 5:
        bits = np.unpackbits(w[4], axis=1, bitorder="little",
                             count=yx16.shape[1]).astype(np.int64)
        yx = ((yx.astype(np.int64) | (bits << 31))
              .astype(np.uint32).view(np.int32))
    return (yx, base.astype(np.int32)[:, None] + dts.astype(np.int32),
            counts)


def _widen(plane: torch.Tensor, mask: int) -> torch.Tensor:
    """A narrow unsigned wire plane (u8, or u16 as its int16 view) as int32
    ``& mask``: the mask drops the sign extension of the int16 view."""
    return plane.to(torch.int32) & mask


def _lane(like: torch.Tensor, n: int) -> torch.Tensor:
    """int32 ``arange(n)`` on ``like``'s device: the position along the
    event axis, which broadcasts over the leading axes."""
    return torch.arange(n, dtype=torch.int32, device=like.device)


def _unpack_polarity_plane(pol: torch.Tensor, capacity: int) -> torch.Tensor:
    """Expand the little-endian bit-packed polarity plane ``[..., B]`` (B =
    ceil(capacity/8) bytes) to int32 ``[..., capacity]``: bit ``i % 8`` of
    byte ``i // 8`` is event i's polarity."""
    rep = _widen(pol, 0xFF).repeat_interleave(8, dim=-1)[..., :capacity]
    return (rep >> (_lane(rep, capacity) & 7)) & 1


def _sub_plain_chunk(yx, ts, counts, pol) -> EventChunk:
    """The EventChunk of a sub-plain tier from its widened yx plane and its
    reconstructed int32 timestamps."""
    cap = yx.shape[-1]
    return EventChunk(
        y=yx >> 8,
        x=yx & 0xFF,
        ts=ts,
        p=torch.zeros_like(yx) if pol is None else _unpack_polarity_plane(pol, cap),
        valid=_lane(yx, cap) < counts.to(torch.int32)[..., None],
    )


def chunks_from_wire_compact(yx, dts, base, counts, pol=None) -> EventChunk:
    """Expand the compact wire tuple (tensors on the device) into an
    :class:`EventChunk`: ``ts = base + dts`` in int32.  ``pol`` is the
    optional bit-packed polarity plane (the five-array form)."""
    yx = _widen(yx, 0xFFFF)
    ts = base.to(torch.int32)[..., None] + _widen(dts, 0xFFFF)
    return _sub_plain_chunk(yx, ts, counts, pol)


def chunks_from_wire_ultra(yx, d8, base, counts, pol=None) -> EventChunk:
    """Expand the ultra wire tuple into an :class:`EventChunk`: ``ts = base
    + cumsum(d8)`` in int32 (exact: the packer bounds each chunk's span
    below 2**16, and the base rides the int32 contract)."""
    yx = _widen(yx, 0xFFFF)
    dts = torch.cumsum(_widen(d8, 0xFF), dim=-1, dtype=torch.int32)
    return _sub_plain_chunk(yx, base.to(torch.int32)[..., None] + dts, counts, pol)


def chunks_from_wire_ultra4(yx, d4, base, counts, pol=None) -> EventChunk:
    """Expand the ultra4 wire tuple into an :class:`EventChunk`: each d4 byte
    carries two little-endian 4-bit deltas (event 2i in the low nibble,
    2i + 1 in the high one), then ``ts = base + cumsum(d)`` in int32."""
    yx = _widen(yx, 0xFFFF)
    cap = yx.shape[-1]
    b = _widen(d4, 0xFF).repeat_interleave(2, dim=-1)[..., :cap]
    d = (b >> ((_lane(b, cap) & 1) << 2)) & 0xF
    dts = torch.cumsum(d, dim=-1, dtype=torch.int32)
    return _sub_plain_chunk(yx, base.to(torch.int32)[..., None] + dts, counts, pol)


def chunks_from_wire(yx: torch.Tensor, ts: torch.Tensor, counts: torch.Tensor,
                     polarity: bool = False) -> EventChunk:
    """Expand the plain wire triple (int32 tensors on the device) into an
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


def chunks_from_wire_any(planes, polarity: bool = False) -> EventChunk:
    """Expand a wire tuple of any tier (its planes on the device, as
    :func:`wire_to_device` gives them) by the tier's unpack; ``polarity``
    is the plain tier's (the sub-plain tiers carry a polarity plane or
    none)."""
    if len(planes) == 3:
        return chunks_from_wire(*planes, polarity=polarity)
    if planes[1].element_size() == 2:  # a u16 ts plane: compact
        return chunks_from_wire_compact(*planes)
    if planes[1].shape[-1] != planes[0].shape[-1]:  # half width: ultra4
        return chunks_from_wire_ultra4(*planes)
    return chunks_from_wire_ultra(*planes)


class PinnedStaging:
    """Pinned host buffers that wire uploads are staged through, reused in
    turn: ``depth`` buffers for each plane shape and dtype, each with an
    event recorded after the copy out of it, which a reuse waits on (the
    copy ``depth`` uploads back; with ``depth`` above a pipeline's
    in-flight window it has long run).  Pinning a fresh buffer for every
    upload costs an allocation through PyTorch's caching host allocator
    each time, more than the copy it saves; the ring pays it once."""

    def __init__(self, depth: int = 4):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._depth = depth
        self._slots: dict = {}
        self._turn: dict = {}

    def upload(self, a: np.ndarray, device: torch.device,
               out: torch.Tensor | None = None) -> torch.Tensor:
        """Copy ``a`` into the next pinned buffer of its shape and dtype and
        enqueue its copy to ``device`` on the current stream: into ``out``
        where given (a tensor of that shape and dtype on ``device``), else
        into a new tensor."""
        key = (a.shape, a.dtype.str)
        slots = self._slots.setdefault(key, [])
        k = self._turn.get(key, 0)
        self._turn[key] = (k + 1) % self._depth
        if k == len(slots):
            dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
            slots.append((torch.empty(a.shape, dtype=dtype, pin_memory=True),
                          torch.cuda.Event()))
        buf, done = slots[k]
        with span("host.sync"):
            done.synchronize()  # the copy out of this buffer has run
        buf.numpy()[...] = a
        if out is None:
            out = buf.to(device, non_blocking=True)
        else:
            out.copy_(buf, non_blocking=True)
        done.record(torch.cuda.current_stream(device))
        return out


def wire_to_device(w, device, staging: PinnedStaging | None = None,
                   out: tuple | None = None) -> tuple:
    """Upload a host wire tuple: each plane as a tensor on ``device`` (a u16
    plane as its int16 view, for torch's ``uint16`` lacks the ops the
    unpacks need), into the planes of ``out`` where given (tensors of
    those shapes and dtypes on ``device``, as an earlier upload gave them).
    To the card each plane goes through the pinned buffers of ``staging``
    (a one-call ring when not given) with a copy that does not block the
    host, enqueued on the current stream, so work enqueued after it on
    that stream reads it complete."""
    device = torch.device(device)
    if device.type == "cuda" and staging is None:
        staging = PinnedStaging(1)
    planes = []
    for k, a in enumerate(w):
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint16:
            a = a.view(np.int16)
        dst = None if out is None else out[k]
        if device.type == "cuda":
            planes.append(staging.upload(a, device, out=dst))
        elif dst is None:
            planes.append(torch.from_numpy(a).to(device))
        else:
            planes.append(dst.copy_(torch.from_numpy(a)))
    return tuple(planes)
