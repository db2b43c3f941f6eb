"""Profiling and timing instrumentation.

Counterpart of ``async_ev_cnn_tpu/utils/profiling.py``:

* :class:`StepTimer` — running per-step stats with events/s, copied;
* :func:`profile_layers` and :func:`profile_layers_parallel` — per-layer
  time attribution by prefix ablation (the network truncated after layer
  k, for every k, and consecutive prefixes differenced), of the sequential
  and of the parallel-in-time engine;
* :func:`trace` — a context manager around ``torch.profiler`` that writes a
  Chrome trace (``chrome://tracing``, Perfetto) and the program's spans.

On the card every probe is timed by CUDA events recorded around its run
after a ``torch.cuda.synchronize()``, so the time is the card's from the
first launch to the last; on the CPU by the host clock.  PyTorch runs
eagerly, so the JAX package's guards against a compiler hoisting or
dropping a probe's work are not needed here.

The port's own spans (this package alone; the JAX package has none):

* :func:`span` — a context manager that the program puts at its layer
  boundaries (``serve.*``, ``scan.*``, ``layer.<name>``, ``conv.*``,
  ``pool.max``, ``step``, ``chunk.upload``, and ``host.sync`` around
  every read by the host that waits for the card).  It records
  ``(name, start_ns, end_ns, parent, request, thread)`` on
  ``time.time_ns()``, the clock of ``torch.profiler``'s records;
  ``parent`` is the index of the enclosing span on the same thread,
  ``request`` a dispatch or chunk number, inherited from the parent.
* The switch: spans record inside a :func:`recording` block and whenever a
  ``torch.profiler`` session runs in the process (torch's
  ``torch.autograd.profiler._is_profiler_enabled``), so any profiler picks
  them up with no option of its own.  Off, a span is two global reads
  and one shared null context: no clock, no allocation.
* :func:`recorded` returns the spans, :func:`clear` empties them and
  :func:`dropped` counts those past :data:`SPAN_LIMIT`, which are dropped.
  A span is kept when it closes, as a tuple of plain values that the
  garbage collector does not track.
  :func:`trace` writes the spans of its block to ``log_dir/spans.json``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

import numpy as np
import torch
import torch.autograd.profiler as _torch_profiler

#: the most spans the recorder keeps; later ones are dropped and counted
SPAN_LIMIT = 4_000_000

_recording = 0  # depth of the open recording() blocks
# closed spans as tuples of plain values, which the garbage collector does
# not track: (id, name, start_ns, end_ns, parent id, request, thread)
_spans: list = []
_dropped = 0
_ids = itertools.count()  # span ids, in the order the spans start
_lock = threading.Lock()  # the bound's check and the counts, across threads
_local = threading.local()  # each thread's stack of open spans
_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "request", "id", "parent", "start")

    def __init__(self, name: str, request):
        self.name, self.request = name, request

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self.parent = None if parent is None else parent.id
        if self.request is None and parent is not None:
            self.request = parent.request
        self.id = next(_ids)
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        end = time.time_ns()
        _local.stack.pop()
        rec = (self.id, self.name, self.start, end, self.parent, self.request,
               threading.get_ident())
        with _lock:
            if len(_spans) < SPAN_LIMIT:
                _spans.append(rec)
            else:
                _dropped += 1
        return False


def span(name: str, request=None):
    """A context manager that records the block as span ``name`` while
    spans record (a :func:`recording` block or a ``torch.profiler``
    session); ``request`` (a dispatch or chunk number) defaults to the
    enclosing span's."""
    if _recording or _torch_profiler._is_profiler_enabled:
        return _Span(name, request)
    return _NULL


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without a profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def recorded() -> list:
    """The spans closed since the last :func:`clear`, in the order they
    started: ``(name, start_ns, end_ns, parent, request, thread)`` tuples,
    ``parent`` the index of the enclosing span in this list (None: none,
    not closed yet, or dropped)."""
    spans = sorted(_spans)
    index = {rec[0]: i for i, rec in enumerate(spans)}
    return [(name, t0, t1, None if parent is None else index.get(parent), request, thread)
            for _, name, t0, t1, parent, request, thread in spans]


def dropped() -> int:
    """The spans dropped past :data:`SPAN_LIMIT` since the last :func:`clear`."""
    return _dropped


def clear() -> None:
    """Forget the recorded spans and the count of dropped ones."""
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0


class StepTimer:
    """Accumulates per-step wall times and event counts."""

    def __init__(self):
        self.times: list[float] = []
        self.events: list[int] = []
        self._t0 = None

    def start(self):
        self._t0 = time.time()

    def stop(self, num_events: int = 0) -> float:
        dt = time.time() - self._t0
        self.times.append(dt)
        self.events.append(num_events)
        return dt

    @property
    def steps(self) -> int:
        return len(self.times)

    def summary(self, skip_warmup: int = 1) -> dict:
        t = np.asarray(self.times[skip_warmup:] or self.times)
        e = np.asarray(self.events[skip_warmup:] or self.events)
        return {
            "steps": self.steps,
            "mean_sec_per_step": float(t.mean()) if t.size else 0.0,
            "p50_sec_per_step": float(np.percentile(t, 50)) if t.size else 0.0,
            "p99_sec_per_step": float(np.percentile(t, 99)) if t.size else 0.0,
            "events_per_sec": float(e.sum() / t.sum()) if t.size and t.sum() else 0.0,
        }


def _elapsed_ms(fn, device) -> float:
    """Milliseconds ``fn()`` takes: on the card by CUDA events around it
    after a synchronize (the card's time from its first launch to its
    last), on the CPU by the host clock."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _best_ms(fn, device, reps: int) -> float:
    fn()  # warm-up: cuDNN's algorithm choice, the kernels' first build
    return min(_elapsed_ms(fn, device) for _ in range(reps))


def profile_layers(net, params, chunks, reps: int = 3, dispatches: int = 4):
    """Per-layer time attribution of the sequential engine by prefix
    ablation: ``dispatches`` passes of :meth:`EventNetwork.forward` over
    the ``[T, E]`` chunks, truncated after layer k, for every k.

    Returns a list of ``(layer_name, ms_per_chunk)`` rows (the first row is
    the integration layer; each later row that layer's marginal cost), plus
    a ``('TOTAL', ...)`` row."""
    from async_ev_cnn_torch.layers.types import EventChunk

    device = chunks.y.device
    state0 = net.init_state(params, device)
    t_chunks = int(chunks.y.shape[0])
    steps = [EventChunk(*(f[k] for f in chunks)) for k in range(t_chunks)]

    def timed(upto):
        def run():
            for _ in range(dispatches):
                st = state0
                for chunk in steps:
                    st, _ = net.forward(params, st, chunk, upto=upto)

        return _best_ms(run, device, reps) / dispatches / t_chunks

    rows = []
    prev = 0.0
    for i, ld in enumerate(net.event_layers):
        total = timed(i)
        rows.append((ld.name, total - prev))
        prev = total
    rows.append(("TOTAL", prev))
    return rows


def profile_layers_parallel(net, params, chunks, reps: int = 3, dispatches: int = 8):
    """Stage attribution of the parallel-in-time path (``scan_parallel``):
    each probe runs the real ``integrate_parallel`` and the T-batched
    network truncated after k layers, ``dispatches`` times chained through
    the surface.  Row 0 ('integrate') is the surface reconstruction; a
    conv+pool pair the forward fuses is one row, as it runs as one op.

    Returns ``[(name, ms_per_dispatch_marginal), ..., ('TOTAL', ms)]``."""
    from async_ev_cnn_torch.layers import conv_stack
    from async_ev_cnn_torch.layers.network import needs_grad
    from async_ev_cnn_torch.ops.integrate import integrate_parallel

    if not net.is_all_full:
        raise ValueError("profile_layers_parallel requires an all-'full' net")
    device = chunks.y.device
    state0 = net.init_state(params, device)
    leak = net.event_layers[0].spec.leak

    def timed(upto):
        def run():
            surf, pts = state0[0].surface, state0[0].prev_ts
            for _ in range(dispatches):
                surfaces, last_ts = integrate_parallel(surf, pts, chunks, leak)
                if upto != 0:
                    net.full_frame_forward(params, state0, surfaces, upto=upto)
                surf, pts = surfaces[-1], last_ts[-1]

        return _best_ms(run, device, reps) / dispatches

    # conv+pool pairs the forward runs as ONE op (a space-to-depth conv,
    # K6, or a conv and its pooled epilogue) must be probed as one row: cutting
    # between them would time an unfused conv that the path never runs
    steps = conv_stack.plan(net, device, needs_grad(chunks.y, params))
    probes = [(0, "integrate")] + [
        (s.start + len(s.layers), "+".join(ld.name for ld in s.layers)
         + (f" ({s.route})" if len(s.layers) > 1 else "")) for s in steps]
    if net.dense_tail:
        probes.append((None, "tail"))  # upto=None: the full forward with its tail
    rows = []
    prev = 0.0
    for upto, name in probes:
        total = timed(upto)
        rows.append((name, total - prev))
        prev = total
    rows.append(("TOTAL", prev))
    return rows


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the block with ``torch.profiler`` (the CPU, and the card where
    there is one) and write its Chrome trace to ``log_dir/trace.json`` and
    the spans the program recorded meanwhile to ``log_dir/spans.json``
    (``time.time_ns()`` nanoseconds, the clock of the trace's records;
    ``parent`` indexes the file's own list); a no-op when ``log_dir`` is
    None.  Yields the profiler (or None)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    first, lost = next(_ids), _dropped
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    mine = sorted(rec for rec in _spans if rec[0] > first)
    index = {rec[0]: i for i, rec in enumerate(mine)}
    keys = ("name", "start_ns", "end_ns", "parent", "request", "thread")
    spans = [dict(zip(keys, (name, t0, t1, index.get(p), request, thread)))
             for _, name, t0, t1, p, request, thread in mine]
    with open(os.path.join(log_dir, "spans.json"), "w") as fh:
        json.dump({"clock": "time.time_ns", "dropped": _dropped - lost, "spans": spans}, fh)
