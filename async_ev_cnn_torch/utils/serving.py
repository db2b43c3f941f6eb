"""Serving loop: event sources -> wire -> chained dispatches on the card.

Counterpart of ``async_ev_cnn_tpu/utils/serving.py`` (its docstring has the
design): each dispatch uploads its wire planes, unpacks them on the device
and runs :meth:`EventNetwork.scan_parallel` over the packed chunks — for
``streams > 1`` over the ``[S, T, E]`` chunks of S independent streams
(the JAX package's ``vmap``): one K1 launch pair and one conv stack over
all S*T frames a dispatch.
Dispatches chain on the device through the carried network state, so the
host never waits for one to finish before enqueueing the next; a bounded
in-flight window applies backpressure, released with ONE scalar fetch per
half-window (the card runs one stream's work in enqueue order, so the
newest popped dispatch's checksum proves every older one retired).
Results are yielded in order as :class:`DispatchResult` with
device-resident ``outputs``.

Events cross the link in the smallest wire tier each item fits
(``wire='auto'``: 2.5 B/event ultra4 -> 3 B ultra -> 4 B compact -> 8 B
plain, :mod:`async_ev_cnn_torch.utils.wire`), from pinned host memory by
copies that do not block the host.  A group of S items unifies to its
highest tier, and the pipeline never drops back below the highest tier it
has dispatched (the tier era), as in the JAX package.

With a ``mesh`` (:func:`~async_ev_cnn_torch.parallel.make_mesh`) every rank
runs a pipeline of its own over the same source: it packs, uploads and
serves only its streams (``streams / n_data`` of each dispatch's items)
through :class:`~async_ev_cnn_torch.parallel.MultiStreamEngine`'s network,
one K1 call a dispatch for all of them, and yields their results.  Its
epochs, rebase ledger, tier era and in-flight window are its own streams';
outputs are not gathered a dispatch (at S=8, T=64 the decoded grids are
31.5 MB): :meth:`StreamingPipeline.gather_results` assembles what the
unsharded pipeline yields.

Three faults of the JAX engine's epoch ledger are fixed here, on every
stream (each has a test that records the divergence):

* F1: a raw-array item applies the pending shift of prepared items that
  were dropped before dispatch as well as its own rebase;
* F2: mixing hand-built ``PreparedItem``s that carry a verbatim
  ``prev_ts`` shift (``epoch=None``) with ``prepare()``/raw rebasing on one
  stream raises instead of shifting ``prev_ts`` twice;
* F3: on an admission error (slot or epoch mismatch, a pre-packed item on
  a rebased stream, an oversize item, unequal chunk counts in a group) the
  dispatches already in flight are yielded before the error is raised.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Iterable, Iterator, NamedTuple

import numpy as np
import torch

from async_ev_cnn_torch.layers.types import IntegrationState
from async_ev_cnn_torch.utils.device import resolve_device
from async_ev_cnn_torch.utils.wire import (
    WIRE_TIERS,
    PinnedStaging,
    chunks_from_wire_any,
    pack_wire,
    pack_wire_compact,
    pack_wire_ultra,
    pack_wire_ultra4,
    wire_format,
    wire_to_device,
    wire_to_tier,
)

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
    ``counts`` (``[T]``, or ``[S, T]`` for multi-stream; zero-count chunks
    are exact no-op padding steps)."""

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
    ``streams`` independent streams share each dispatch: :meth:`serve`
    takes ``streams`` consecutive source items a dispatch, one a stream
    slot, and the state carries a leading stream axis on every leaf.
    ``wire`` is ``'auto'`` (the smallest tier each item fits) or pins a
    tier (``'ultra4'``, ``'ultra'`` and ``'compact'`` raise on an item that
    does not fit).  ``mesh`` (a ``(data, model)`` mesh) serves this rank's
    ``streams / n_data`` streams, ``streams >= 2`` and divisible by the
    data axis; ``device`` is then the mesh's.  ``postprocess`` is applied
    to each dispatch's ``[T, ...]`` (``[S, T, ...]``, the rank's streams
    on a mesh) network outputs on the device.
    """

    def __init__(self, net, params, *, capacity=256, window=None,
                 streams=1, max_in_flight=16, wire="auto",
                 postprocess=None, mesh=None, keep_polarity=False,
                 rebase=True, t_chunks=None, device=None):
        if streams < 1:
            raise ValueError("streams must be >= 1")
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        if wire not in _WIRES:
            raise ValueError(
                "wire must be 'auto', 'ultra4', 'ultra', 'compact' or 'plain'")
        if keep_polarity and net.event_layers[0].spec.channels != 2:
            raise ValueError(
                "keep_polarity serving needs a 2-channel (ON/OFF) surface "
                "network — the first conv's in_channels must be 2, got "
                f"{net.event_layers[0].spec.channels}"
            )
        if streams > 1 and getattr(net, "_stem_fusion", None) == "auto":
            # as in the JAX engine: 'auto' was measured on the one-stream
            # dispatch, and the engine, which knows `streams`, turns it off
            # for the batched shape; an explicit True/False is respected
            net = net.with_stem_fusion(False)
        self._engine = None
        self._slots = range(streams)  # the stream slots this pipeline serves
        if mesh is not None:
            from async_ev_cnn_torch.parallel import MultiStreamEngine

            engine = MultiStreamEngine(net, mesh)
            if streams < 2 or streams % engine.n_data:
                raise ValueError(
                    f"mesh serving needs streams (= {streams}) divisible by the "
                    f"mesh's data axis (= {engine.n_data})")
            rows = engine.streams(streams)
            self._slots = range(rows.start, rows.stop)
            self._engine = engine
            net = engine.net
            device = engine.device
        self._device = resolve_device(device)
        self._net = net
        self._capacity = capacity
        self._window = window
        self._streams = streams
        self._max_in_flight = max_in_flight
        self._wire = wire
        self._keep_polarity = keep_polarity
        self._rebase = rebase
        self._t_chunks = t_chunks
        self._post = postprocess if postprocess is not None else (lambda outs: outs)
        if self._engine is not None:
            self._params = self._engine.place_params(params)
            state = self._engine.init_states(params, streams)
        else:
            self._params = {k: torch.as_tensor(v, device=self._device)
                            for k, v in params.items()}
            state = net.init_state(self._params, self._device)
            if streams > 1:
                state = tuple(type(s)(*(f.expand(streams, *f.shape).clone() for f in s))
                              for s in state)
        self._state = state
        #: per-stream int64 µs epoch subtracted from raw source timestamps
        self._epochs = [0] * streams
        #: per-stream epoch actually applied on the device (prev_ts shifted
        #: at dispatch); trails ``_epochs`` while prepared items are queued
        self._applied_epochs = [0] * streams
        #: per stream: a hand-built item shifted prev_ts verbatim (F2)
        self._verbatim_shift = [False] * streams
        #: cumulative serve() counters
        self.stats = {"dispatches": 0, "wire_bytes": 0, "events": 0}
        # (latency_s, age_s) per retired dispatch for latency_stats()
        self._lat: deque = deque(maxlen=4096)
        # highest wire tier dispatched so far (WIRE_TIERS rank): later
        # dispatches never drop back below it
        self._era = WIRE_TIERS.get(wire, 0)
        # pinned buffers the uploads are staged through: one more than the
        # dispatches in flight, and one for the upload being staged
        self._staging = PinnedStaging(max_in_flight + 2)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def wire_tier(self) -> str:
        """The tier the pipeline dispatches at now (its tier era)."""
        return next(t for t, r in WIRE_TIERS.items() if r == self._era)

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
        """Current network state (a tuple of per-layer NamedTuples; every
        leaf with a leading stream axis when ``streams > 1``); on a mesh,
        this rank's shard of it."""
        return self._state

    @state.setter
    def state(self, new):
        """Install a restored mid-stream state; its structure (layer types,
        field shapes and dtypes) must match the pipeline's (on a mesh: this
        rank's shard, as :attr:`state` gives it).  Rebase epochs are not
        part of the state (see the JAX engine's setter)."""
        def structure(st):
            return [(type(s), tuple((tuple(f.shape), torch.as_tensor(f).dtype)
                                    for f in s)) for s in st]

        if structure(new) != structure(self._state):
            raise ValueError(
                "restored state structure does not match this pipeline's "
                "(different network spec or stream count?)")
        self._state = tuple(
            type(s)(*(torch.as_tensor(f, device=self._device) for f in s))
            for s in new)

    def gather_results(self, results) -> list[DispatchResult]:
        """What the unsharded pipeline yields, from this rank's results of a
        mesh pipeline: every ``data`` rank's streams of each dispatch's
        outputs (tensors, or tuples of them, with the stream axis first)
        and counts, and the events summed.  A collective: every rank calls
        it with the results of the same dispatches.  Without a mesh the
        results are returned as they are."""
        eng = self._engine
        if eng is None:
            return list(results)
        out = []
        for r in results:
            counts = eng.gather(torch.from_numpy(np.asarray(r.counts)), dim=0).numpy()
            n = int(eng.data.sum(torch.tensor([r.n_events], dtype=torch.int64)))
            out.append(DispatchResult(
                _map_tensors(lambda x: eng.gather(x, dim=0), r.outputs), n, counts))
        return out

    def pack(self, events: np.ndarray, t_chunks: int | None = None):
        """Pack a host ``[N, >=3]`` event array into this pipeline's wire
        tuple: under 'auto' the smallest tier it fits, never below the tier
        era; a pinned tier raises on an item that does not fit it.  Padded
        to ``t_chunks`` chunks (default: the pipeline's) with zero-count
        no-op chunks; raises if the events need more."""
        era = self._era if self._wire == "auto" else 0
        kp = self._keep_polarity
        w = None
        if self._wire == "ultra4" or (self._wire == "auto" and era <= WIRE_TIERS["ultra4"]):
            w = pack_wire_ultra4(events, self._capacity, keep_polarity=kp)
            if w is None and self._wire == "ultra4":
                raise ValueError(
                    "stream does not fit the ultra4 wire (coords >= 256, "
                    "within-chunk ts gap >= 16 us, non-monotone "
                    "within-chunk ts, or capacity < 2); use wire='auto'"
                )
        if w is None and (self._wire == "ultra" or (
                self._wire == "auto" and era <= WIRE_TIERS["ultra"])):
            w = pack_wire_ultra(events, self._capacity, keep_polarity=kp)
            if w is None and self._wire == "ultra":
                raise ValueError(
                    "stream does not fit the ultra wire (coords >= 256, "
                    "within-chunk ts gap >= 256 us, or non-monotone "
                    "within-chunk ts); use wire='auto'"
                )
        if w is None and (self._wire == "compact" or (
                self._wire == "auto" and era <= WIRE_TIERS["compact"])):
            w = pack_wire_compact(events, self._capacity, keep_polarity=kp)
            if w is None and self._wire == "compact":
                raise ValueError(
                    "stream does not fit the compact wire (coords >= 256 "
                    "or chunk ts span >= 2**16 us); use wire='auto'"
                )
        if w is None:
            w = pack_wire(events, self._capacity, keep_polarity=kp)
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

    def _rebase_stream(self, ev: np.ndarray, i: int) -> tuple[np.ndarray, int]:
        """Apply stream ``i``'s epoch to a raw event array, advancing the
        epoch when the relative clock passes the rebase threshold; returns
        the array and this item's rebase (µs, 0 for none)."""
        d = 0
        if self._rebase and ev.shape[0]:
            ts64 = ev[:, 2].astype(np.int64) - self._epochs[i]
            if ts64.max() >= _REBASE_AT:
                d = int(ts64.min())
                if d < 0:
                    raise ValueError(
                        f"stream {i} timestamps regressed below the stream's "
                        "time base (non-monotone source); cannot rebase")
                if self._verbatim_shift[i]:
                    raise ValueError(self._mix_error(i))
                self._epochs[i] += d
                ts64 -= d
            if self._epochs[i]:
                ev = ev.astype(np.int64, copy=True)
                ev[:, 2] = ts64
        return ev, d

    @staticmethod
    def _mix_error(i: int) -> str:
        return (f"stream {i} mixes hand-built PreparedItems carrying a "
                "verbatim prev_ts shift (epoch=None) with prepare()/raw-array "
                "rebasing: the shift would be applied twice — use one or "
                "the other on a stream")

    def prepare(self, events: np.ndarray, stream: int = 0,
                t_chunks: int | None = None) -> PreparedItem:
        """Rebase + :meth:`pack` one raw ``[N, >=3]`` item for ``stream`` on
        the caller's thread (items of a stream must be prepared in serve
        order by one thread).  The item records its stream and the stream's
        epoch after its rebase; :meth:`serve` checks the stream against the
        slot and derives the device shift from the epoch ledger, so items
        dropped between prepare and dispatch are absorbed."""
        ev, d = self._rebase_stream(np.asarray(events), stream)
        return PreparedItem(self.pack(ev, t_chunks), _halves(d), time.time(),
                            stream, self._epochs[stream])

    def _ledger_shift(self, i: int, epoch: int) -> np.ndarray:
        """The prev_ts shift that brings stream ``i``'s device clock up to
        ``epoch``."""
        d = epoch - self._applied_epochs[i]
        if d < 0:
            raise ValueError(
                f"stream {i} PreparedItem epoch regressed ({epoch} < "
                f"{self._applied_epochs[i]} µs): items were prepared out of "
                "serve order")
        self._applied_epochs[i] = epoch
        return _halves(d)

    def _admit(self, item, i: int):
        """Validate the source item of stream slot ``i``; returns ``(wire,
        deltas)``."""
        if isinstance(item, PreparedItem):
            if item.epoch is not None:
                return item.wire, self._ledger_shift(i, item.epoch)
            deltas = np.asarray(item.deltas, np.int32)
            if deltas.any():
                if self._epochs[i]:
                    raise ValueError(self._mix_error(i))  # F2
                self._verbatim_shift[i] = True
            return item.wire, deltas
        if isinstance(item, tuple):
            if self._epochs[i]:
                raise ValueError(
                    f"stream {i} runs on a rebased time base (epoch "
                    f"{self._epochs[i]} us) but received a pre-packed wire "
                    "item, whose time base is unknowable — feed raw event "
                    "arrays (or prepare() items) on streams that outlive the "
                    "int32 us range")
            return item, np.zeros(2, np.int32)
        ev, _ = self._rebase_stream(np.asarray(item), i)
        # F1: the ledger carries any shift still pending from prepared
        # items dropped before dispatch, as well as this item's rebase
        return self.pack(ev), self._ledger_shift(i, self._epochs[i])

    def _chunk_count(self, item, i: int) -> int:
        """The chunks the source item of stream slot ``i`` gives a dispatch,
        from its size and its slot alone (nothing is packed or admitted)."""
        if isinstance(item, PreparedItem):
            if item.stream is not None and item.stream != i:
                raise ValueError(
                    f"dispatch slot {i} received a PreparedItem for stream "
                    f"{item.stream}: a shared producer queue delivered "
                    "streams out of round-robin order — keep one ordered "
                    "source slot per stream")
            return item.wire[0].shape[0]
        if isinstance(item, tuple):
            return item[0].shape[0]
        t = max(1, -(-len(item) // self._capacity))  # pack_wire's chunks
        if self._t_chunks is None:
            return t
        if t > self._t_chunks:
            raise ValueError(
                f"{t} chunks of {self._capacity} events exceed "
                f"t_chunks={self._t_chunks}; feed fewer events per item")
        return self._t_chunks

    def _admit_group(self, group):
        """Admit one dispatch's items of this pipeline's stream slots (all
        of them without a mesh) and unify their wire tiers; returns
        ``(wires, deltas [2, S])``.  The group's shape is checked on every
        item first, so on a mesh every rank raises on the same group before
        any of them reaches a collective."""
        ts = {self._chunk_count(item, i) for i, item in enumerate(group)}
        if len(ts) > 1:
            raise ValueError(
                "streams must supply equally many chunks per dispatch "
                f"(got chunk counts {sorted(ts)}); pad or rebatch the source")
        deltas = np.zeros((2, len(self._slots)), np.int32)
        wires = []
        for j, i in enumerate(self._slots):
            w, deltas[:, j] = self._admit(group[i], i)
            wires.append(w)
        # every tier re-encodes exactly to any higher one on the host: a
        # mixed group unifies to its highest tier, and the pipeline never
        # drops back below the highest tier it has dispatched
        self._era = max(self._era, *(WIRE_TIERS[wire_format(w)] for w in wires))
        wires = [wire_to_tier(w, self.wire_tier) for w in wires]
        return wires, deltas

    def _shift_prev_ts(self, st, deltas: np.ndarray):
        """Rebase shift on the device: two floor-clipped int32 subtractions
        of halves <= 2**30, so no intermediate underflows.  The floor binds
        only after a gap of more than ~17.9 min, when the surface has
        leaked to zero anyway.  ``deltas`` is ``[2]`` (Python scalars reach
        the card with the launch) or ``[2, S]`` (uploaded like the wire,
        and only when a stream shifts)."""
        intgr = st[0]
        if deltas.ndim == 1:
            d_a, d_b = int(deltas[0]), int(deltas[1])
        elif deltas.any():
            d_a, d_b = wire_to_device((deltas,), self._device, self._staging)[0]
        else:
            return st
        prev = torch.clamp(intgr.prev_ts - d_a, min=_PREV_TS_FLOOR)
        prev = torch.clamp(prev - d_b, min=_PREV_TS_FLOOR)
        return (IntegrationState(intgr.surface, prev),) + tuple(st[1:])

    def _dispatch(self, wire, deltas):
        st = self._shift_prev_ts(self._state, deltas)
        chunks = chunks_from_wire_any(wire_to_device(wire, self._device, self._staging),
                                      polarity=self._keep_polarity)
        st, outs = self._net.scan_parallel(self._params, st, chunks, window=self._window)
        # tiny checksum for retirement syncs: one scalar fetch proves it
        return st, self._post(outs), outs.mean()

    def serve(self, source: Iterable) -> Iterator[DispatchResult]:
        """Drive the pipeline over ``source`` — host ``[N, >=3]`` event
        arrays, wire tuples from :meth:`pack`, or :class:`PreparedItem`s
        from :meth:`prepare` — yielding one in-order
        :class:`DispatchResult` per dispatch once its retirement on the
        card is proven.  With ``streams > 1`` every ``streams`` consecutive
        items form one dispatch (item k feeds stream slot ``k % streams``)
        and a ragged tail is dropped.  The network state persists across
        calls.  On a mesh every rank takes the same source and yields its
        own streams' results (:meth:`gather_results` assembles them)."""
        it = iter(source)
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

        while True:
            group = []
            for item in it:
                group.append(item)
                if len(group) == self._streams:
                    break
            if len(group) < self._streams:
                break  # the source is done; a ragged tail is dropped
            # arrival is stamped after the source yields: waiting for the
            # source is not staleness; a PreparedItem's events exist from
            # its prepare() call, and the dispatch ages from its oldest
            t_arrival = time.time()
            for item in (group[i] for i in self._slots):
                if isinstance(item, PreparedItem) and item.t_created is not None:
                    t_arrival = min(t_arrival, item.t_created)
            try:
                wires, deltas = self._admit_group(group)
            except ValueError:
                yield from release(0)  # F3: completed work is not lost
                raise
            # the counts plane: index 2 in the plain triple, 3 in the
            # sub-plain tiers (the polarity plane, when present, is last)
            counts = [w[2] if len(w) == 3 else w[3] for w in wires]
            n = sum(int(c.sum()) for c in counts)
            if self._streams == 1:  # no stream axis (a mesh has S >= 2)
                wire, counts, deltas = wires[0], counts[0], deltas[:, 0]
            else:
                wire = tuple(np.stack(parts) for parts in zip(*wires))
                counts = np.stack(counts)
            self.stats["dispatches"] += 1
            self.stats["wire_bytes"] += sum(a.nbytes for a in wire)
            self.stats["events"] += n
            self._state, outs, chk = self._dispatch(wire, deltas)
            in_flight.append((outs, n, chk, counts, time.time(), t_arrival))
            if len(in_flight) >= self._max_in_flight:
                yield from release(self._max_in_flight // 2)
        yield from release(0)


def _map_tensors(fn, x):
    """``fn`` over the tensors of a (nested) tuple or list of tensors."""
    if isinstance(x, (tuple, list)):
        return type(x)(_map_tensors(fn, v) for v in x)
    return fn(x)


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
