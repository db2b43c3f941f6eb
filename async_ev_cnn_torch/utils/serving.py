"""Serving loop: event source -> wire -> chained dispatches on the card.

Counterpart of ``async_ev_cnn_tpu/utils/serving.py`` (its docstring has the
design): each dispatch unpacks the wire on the device and runs
:meth:`EventNetwork.scan_parallel` over the packed chunks; dispatches chain
on the device through the carried network state, so the host never waits
for one to finish before enqueueing the next; a bounded in-flight window
applies backpressure, released with ONE scalar fetch per half-window (the
card runs one stream's work in enqueue order, so the newest popped
dispatch's checksum proves every older one retired).  Results are yielded
in order as :class:`DispatchResult` with device-resident ``outputs``.

This slice serves one stream (``streams=1``, ``mesh=None``) over the plain
8 B wire; the other tiers, multi-stream batching and mesh serving raise
``NotImplementedError`` until their slices.

Three faults of the JAX engine's epoch ledger are fixed here (each has a
test that records the divergence):

* F1: a raw-array item applies the pending shift of prepared items that
  were dropped before dispatch as well as its own rebase;
* F2: mixing hand-built ``PreparedItem``s that carry a verbatim
  ``prev_ts`` shift (``epoch=None``) with ``prepare()``/raw rebasing on one
  stream raises instead of shifting ``prev_ts`` twice;
* F3: on an admission error (slot or epoch mismatch, a pre-packed item on
  a rebased stream, an oversize item) the dispatches already in flight are
  yielded before the error is raised.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Iterable, Iterator, NamedTuple

import numpy as np
import torch

from async_ev_cnn_torch.layers.types import IntegrationState
from async_ev_cnn_torch.utils.device import resolve_device
from async_ev_cnn_torch.utils.wire import chunks_from_wire, pack_wire

# int32 µs wraps at ~35.8 min: a stream's time base is rebased once its
# relative clock passes 2**30 µs (~17.9 min); the state's prev_ts shifts
# by the same delta on the device, which is exact (the integrate
# arithmetic uses only timestamp differences).
_REBASE_AT = 2**30
# floor of the device-side prev_ts shift (see _shift_prev_ts)
_PREV_TS_FLOOR = -(2**30) + 1

_WIRES = ("auto", "ultra4", "ultra", "compact", "plain")


class PreparedItem(NamedTuple):
    """One raw source item after :meth:`StreamingPipeline.prepare`: the
    packed wire tuple plus the two int32 ``prev_ts`` shift halves of its
    rebase (if any).  See the JAX package for the field contracts."""

    wire: tuple
    deltas: np.ndarray  # int32 [2] prev_ts shift halves (zeros: no rebase)
    #: wall-clock of prepare(): event-age staleness counts from here
    t_created: float | None = None
    #: stream this item was prepared for (validated against the slot)
    stream: int | None = None
    #: the stream's cumulative rebase epoch (µs) after this item's rebase;
    #: ``None`` (hand-built items): ``deltas`` are applied verbatim
    epoch: int | None = None


class DispatchResult(NamedTuple):
    """One retired dispatch: the device-resident postprocessed ``outputs``,
    the valid events consumed, and the host int32 per-chunk valid-event
    ``counts`` (zero-count chunks are exact no-op padding steps)."""

    outputs: Any
    n_events: int
    counts: Any = None


def _halves(d: int) -> np.ndarray:
    """A prev_ts shift as two int32 halves <= 2**30 (capped at 2**31)."""
    d = min(d, 2**31)
    return np.array([d // 2, d - d // 2], np.int32)


class StreamingPipeline:
    """Chained-dispatch serving engine for an all-'full' EventNetwork.

    Parameters are those of the JAX engine plus ``device`` (``cuda`` when
    not given; raises where there is none).  ``params`` are the port's
    tensors (:func:`~async_ev_cnn_torch.utils.weights.params_from_jax`).
    ``wire`` defaults to ``'plain'``, the only tier of this slice;
    ``streams`` must be 1 and ``mesh`` ``None``.  ``postprocess`` is
    applied to each dispatch's ``[T, ...]`` network outputs on the device.
    """

    def __init__(self, net, params, *, capacity=256, window=None,
                 streams=1, max_in_flight=16, wire="plain",
                 postprocess=None, mesh=None, keep_polarity=False,
                 rebase=True, t_chunks=None, device=None):
        if streams < 1:
            raise ValueError("streams must be >= 1")
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        if wire not in _WIRES:
            raise ValueError(
                "wire must be 'auto', 'ultra4', 'ultra', 'compact' or 'plain'")
        if wire != "plain":
            raise NotImplementedError(
                f"wire={wire!r} waits for the port's wire-tier slice; this "
                "slice ships the plain 8 B wire")
        if streams != 1:
            raise NotImplementedError(
                "multi-stream serving waits for the port's multi-stream slice")
        if mesh is not None:
            raise NotImplementedError(
                "mesh serving waits for the port's multi-device slice")
        if keep_polarity and net.event_layers[0].spec.channels != 2:
            raise ValueError(
                "keep_polarity serving needs a 2-channel (ON/OFF) surface "
                "network — the first conv's in_channels must be 2, got "
                f"{net.event_layers[0].spec.channels}"
            )
        self._device = resolve_device(device)
        self._net = net
        self._capacity = capacity
        self._window = window
        self._max_in_flight = max_in_flight
        self._keep_polarity = keep_polarity
        self._rebase = rebase
        self._t_chunks = t_chunks
        self._post = postprocess if postprocess is not None else (lambda outs: outs)
        self._params = {k: torch.as_tensor(v, device=self._device)
                        for k, v in params.items()}
        self._state = net.init_state(self._params, self._device)
        #: int64 µs epoch subtracted from raw source timestamps
        self._epoch = 0
        #: epoch actually applied on the device (prev_ts shifted at
        #: dispatch); trails ``_epoch`` while prepared items are queued
        self._applied_epoch = 0
        #: a hand-built item shifted prev_ts verbatim (F2)
        self._verbatim_shift = False
        #: cumulative serve() counters
        self.stats = {"dispatches": 0, "wire_bytes": 0, "events": 0}
        # (latency_s, age_s) per retired dispatch for latency_stats()
        self._lat: deque = deque(maxlen=4096)

    @property
    def device(self) -> torch.device:
        return self._device

    def latency_stats(self) -> dict:
        """Per-dispatch ``dispatch_latency_ms`` (enqueue -> proven retired)
        and ``event_age_ms`` (arrival -> proven retired) quantiles over the
        last 4096 retired dispatches.  Both are upper bounds: retirement is
        proven only at the watermark fetches."""
        if not self._lat:
            return {"n": 0}
        lat = np.array([l for l, _ in self._lat]) * 1e3
        age = np.array([a for _, a in self._lat]) * 1e3

        def q(a):
            return {
                "p50": round(float(np.percentile(a, 50)), 3),
                "p95": round(float(np.percentile(a, 95)), 3),
                "p99": round(float(np.percentile(a, 99)), 3),
                "max": round(float(a.max()), 3),
            }

        return {"n": len(self._lat), "dispatch_latency_ms": q(lat),
                "event_age_ms": q(age)}

    @property
    def state(self):
        """Current network state (a tuple of per-layer NamedTuples)."""
        return self._state

    @state.setter
    def state(self, new):
        """Install a restored mid-stream state; its structure (layer types,
        field shapes and dtypes) must match the pipeline's.  Rebase epochs
        are not part of the state (see the JAX engine's setter)."""
        def structure(st):
            return [(type(s), tuple((tuple(f.shape), torch.as_tensor(f).dtype)
                                    for f in s)) for s in st]

        if structure(new) != structure(self._state):
            raise ValueError(
                "restored state structure does not match this pipeline's "
                "(different network spec?)")
        self._state = tuple(
            type(s)(*(torch.as_tensor(f, device=self._device) for f in s))
            for s in new)

    def pack(self, events: np.ndarray, t_chunks: int | None = None):
        """Pack a host ``[N, >=3]`` event array into the plain wire triple,
        padded to ``t_chunks`` chunks (default: the pipeline's) with
        zero-count no-op chunks; raises if the events need more."""
        w = pack_wire(events, self._capacity, keep_polarity=self._keep_polarity)
        if t_chunks is None:
            t_chunks = self._t_chunks
        if t_chunks is not None:
            t0 = w[0].shape[0]
            if t0 > t_chunks:
                raise ValueError(
                    f"{t0} chunks of {self._capacity} events exceed "
                    f"t_chunks={t_chunks}; feed fewer events per item"
                )
            if t0 < t_chunks:
                w = tuple(
                    np.concatenate(
                        [a, np.zeros((t_chunks - t0, *a.shape[1:]), a.dtype)])
                    for a in w
                )
        return w

    def _rebase_stream(self, ev: np.ndarray) -> tuple[np.ndarray, int]:
        """Apply the stream's epoch to a raw event array, advancing the
        epoch when the relative clock passes the rebase threshold; returns
        the array and this item's rebase (µs, 0 for none)."""
        d = 0
        if self._rebase and ev.shape[0]:
            ts64 = ev[:, 2].astype(np.int64) - self._epoch
            if ts64.max() >= _REBASE_AT:
                d = int(ts64.min())
                if d < 0:
                    raise ValueError(
                        "stream 0 timestamps regressed below the stream's "
                        "time base (non-monotone source); cannot rebase")
                if self._verbatim_shift:
                    raise ValueError(self._mix_error())
                self._epoch += d
                ts64 -= d
            if self._epoch:
                ev = ev.astype(np.int64, copy=True)
                ev[:, 2] = ts64
        return ev, d

    @staticmethod
    def _mix_error() -> str:
        return ("stream 0 mixes hand-built PreparedItems carrying a verbatim "
                "prev_ts shift (epoch=None) with prepare()/raw-array "
                "rebasing: the shift would be applied twice — use one or "
                "the other on a stream")

    def prepare(self, events: np.ndarray, stream: int = 0,
                t_chunks: int | None = None) -> PreparedItem:
        """Rebase + :meth:`pack` one raw ``[N, >=3]`` item on the caller's
        thread (items of a stream must be prepared in serve order by one
        thread).  The item records the stream's epoch after its rebase;
        :meth:`serve` derives the device shift from the epoch ledger, so
        items dropped between prepare and dispatch are absorbed."""
        ev, d = self._rebase_stream(np.asarray(events))
        return PreparedItem(self.pack(ev, t_chunks), _halves(d), time.time(),
                            stream, self._epoch)

    def _ledger_shift(self, epoch: int) -> np.ndarray:
        """The prev_ts shift that brings the device up to ``epoch``."""
        d = epoch - self._applied_epoch
        if d < 0:
            raise ValueError(
                f"stream 0 PreparedItem epoch regressed ({epoch} < "
                f"{self._applied_epoch} µs): items were prepared out of "
                "serve order")
        self._applied_epoch = epoch
        return _halves(d)

    def _admit(self, item):
        """Validate one source item; returns ``(wire, deltas)``."""
        if isinstance(item, PreparedItem):
            if item.stream is not None and item.stream != 0:
                raise ValueError(
                    f"dispatch slot 0 received a PreparedItem for stream "
                    f"{item.stream}: keep one ordered source slot per stream")
            if item.epoch is not None:
                return item.wire, self._ledger_shift(item.epoch)
            deltas = np.asarray(item.deltas, np.int32)
            if deltas.any():
                if self._epoch:
                    raise ValueError(self._mix_error())  # F2
                self._verbatim_shift = True
            return item.wire, deltas
        if isinstance(item, tuple):
            if self._epoch:
                raise ValueError(
                    f"stream 0 runs on a rebased time base (epoch "
                    f"{self._epoch} us) but received a pre-packed wire item, "
                    "whose time base is unknowable — feed raw event arrays "
                    "(or prepare() items) on streams that outlive the int32 "
                    "us range")
            return item, np.zeros(2, np.int32)
        ev, _ = self._rebase_stream(np.asarray(item))
        # F1: the ledger carries any shift still pending from prepared
        # items dropped before dispatch, as well as this item's rebase
        return self.pack(ev), self._ledger_shift(self._epoch)

    def _shift_prev_ts(self, st, deltas: np.ndarray):
        """Rebase shift on the device: two floor-clipped int32 subtractions
        of halves <= 2**30, so no intermediate underflows.  The floor binds
        only after a gap of more than ~17.9 min, when the surface has
        leaked to zero anyway."""
        intgr = st[0]
        d_a, d_b = int(deltas[0]), int(deltas[1])
        prev = torch.clamp(intgr.prev_ts - d_a, min=_PREV_TS_FLOOR)
        prev = torch.clamp(prev - d_b, min=_PREV_TS_FLOOR)
        return (IntegrationState(intgr.surface, prev),) + tuple(st[1:])

    def _dispatch(self, wire, deltas):
        st = self._shift_prev_ts(self._state, deltas)
        planes = [torch.from_numpy(np.ascontiguousarray(a)).to(self._device)
                  for a in wire]
        chunks = chunks_from_wire(*planes, polarity=self._keep_polarity)
        st, outs = self._net.scan_parallel(self._params, st, chunks,
                                           window=self._window)
        # tiny checksum for retirement syncs: one scalar fetch proves it
        return st, self._post(outs), outs.mean()

    def serve(self, source: Iterable) -> Iterator[DispatchResult]:
        """Drive the pipeline over ``source`` — host ``[N, >=3]`` event
        arrays, wire tuples from :meth:`pack`, or :class:`PreparedItem`s
        from :meth:`prepare` — yielding one in-order
        :class:`DispatchResult` per item once its retirement on the card is
        proven.  The network state persists across calls."""
        in_flight: deque = deque()

        def release(bound):
            popped = []
            while len(in_flight) > bound:
                popped.append(in_flight.popleft())
            if popped:
                float(popped[-1][2])  # one scalar fetch proves retirement
                t_ret = time.time()
                for outs, n, _, counts, t_enq, t_arr in popped:
                    self._lat.append((t_ret - t_enq, t_ret - t_arr))
                    yield DispatchResult(outs, n, counts)

        for item in source:
            # arrival is stamped after the source yields: waiting for the
            # source is not staleness; a PreparedItem's events exist from
            # its prepare() call
            t_arrival = time.time()
            if isinstance(item, PreparedItem) and item.t_created is not None:
                t_arrival = min(t_arrival, item.t_created)
            try:
                wire, deltas = self._admit(item)
            except ValueError:
                yield from release(0)  # F3: completed work is not lost
                raise
            counts = wire[2]
            n = int(counts.sum())
            self.stats["dispatches"] += 1
            self.stats["wire_bytes"] += sum(a.nbytes for a in wire)
            self.stats["events"] += n
            self._state, outs, chk = self._dispatch(wire, deltas)
            in_flight.append((outs, n, chk, counts, time.time(), t_arrival))
            if len(in_flight) >= self._max_in_flight:
                yield from release(self._max_in_flight // 2)
        yield from release(0)


def threaded_source(make_items, fn=None, depth=4,
                    threads=2) -> Iterator[np.ndarray]:
    """Pull items from ``make_items`` (a callable returning a fresh
    iterable of cheap descriptors, e.g. ``lambda: iter(paths)``) through
    ``threads`` background workers with a bounded queue, applying ``fn``
    (the expensive per-item transform, e.g. decode+:meth:`pack`) INSIDE
    the workers — the host stage overlaps the device pipe.  Workers stride
    the descriptor sequence so the transform runs once per item; ordering
    within a stride is preserved, across workers it is approximate, which
    is fine for independent files.  Copied from the JAX package."""
    import itertools
    import queue as queue_mod
    import threading

    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=depth)
    stop = threading.Event()
    n_live = threading.Semaphore(0)
    fn = fn if fn is not None else (lambda x: x)

    _ERR = object()  # sentinel: (_ERR, exception) — re-raised in the consumer

    def _put(out):
        while not stop.is_set():
            try:
                q.put(out, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def work(offset):
        try:
            for item in itertools.islice(make_items(), offset, None, threads):
                if not _put(fn(item)):
                    break
        except BaseException as e:  # noqa: BLE001 — propagated, not swallowed
            _put((_ERR, e))
        finally:
            n_live.release()

    for k in range(threads):
        threading.Thread(target=work, args=(k,), daemon=True).start()

    done = 0
    try:
        while True:
            try:
                out = q.get(timeout=0.1)
            except queue_mod.Empty:
                while n_live.acquire(blocking=False):
                    done += 1
                if done == threads and q.empty():
                    return
                continue
            if isinstance(out, tuple) and len(out) == 2 and out[0] is _ERR:
                raise out[1]
            yield out
    finally:
        stop.set()
