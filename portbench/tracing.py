"""The traced run: spans around the program's layer entries, the device
trace, and its reduction to device time a span, busy time and gaps.

Each per-layer metric file names the entries it reads in ``WRAP``: tuples
``(module, attribute, span)``, where ``attribute`` may be
``Class.method``, and optionally a fourth item, a function of the call's
arguments whose small result is kept in call order (``Tracer.kept``).
The harness replaces each entry where its callers look it up, with a
function that, while the trace runs, records the call's span on the host
clock that the profiler's records use (``time.time_ns``).

The profiler records the card's activity only (kernels, copies, fills and
the runtime calls that launched them): recording every host operator as
well slowed the host-bound cells by half or more.  A kernel belongs to a
span when the runtime call that launched it (matched by its CUPTI
correlation id) started inside the span.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import time

WINDOW_RANGE = "portbench.window"
SOURCE_RANGE = "portbench.source"


def _resolve(module: str, attribute: str):
    owner = importlib.import_module(module)
    *path, name = attribute.split(".")
    for part in path:
        owner = getattr(owner, part)
    return owner, name


class Tracer:
    """Installs the spans of ``wraps``, and traces the part of a run between
    :meth:`start` and :meth:`stop`."""

    def __init__(self, wraps):
        self.wraps = list(dict.fromkeys(tuple(w) for w in wraps))
        self.kept: list = []
        self.spans: list = []
        self.active = False
        self._saved: list = []
        self.prof = None

    def install(self) -> None:
        for entry in self.wraps:
            module, attribute, name = entry[:3]
            keep = entry[3] if len(entry) > 3 else None
            owner, attr = _resolve(module, attribute)
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))

            def wrapped(*args, _fn=fn, _name=name, _keep=keep, **kwargs):
                if not self.active:
                    return _fn(*args, **kwargs)
                if _keep is not None:
                    self.kept.append((_name, _keep(*args, **kwargs)))
                with self.span(_name):
                    return _fn(*args, **kwargs)

            setattr(owner, attr, functools.wraps(fn)(wrapped))

    def uninstall(self) -> None:
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()

    @contextlib.contextmanager
    def span(self, name: str):
        """Record the block's span while the trace runs."""
        if not self.active:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def _profile(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        return profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])

    def prepare(self) -> None:
        """Set-up: one short trace, so that the profiler's first start (some
        seconds on the card) falls before the window."""
        with self._profile():
            pass

    def start(self) -> None:
        self.prof = self._profile()
        self.prof.start()
        self.active = True
        self._t0 = time.time_ns()

    def stop(self) -> None:
        self.spans.append((WINDOW_RANGE, self._t0, time.time_ns()))
        self.active = False
        self.prof.stop()

    def events(self) -> "TraceEvents":
        return TraceEvents.from_kineto(self.prof.profiler.kineto_results.events(),
                                       self.spans)


class TraceEvents:
    """The trace as plain tuples (ns on the host's real-time clock):

    * ``spans``: ``(name, start, end)``, the spans the harness recorded;
    * ``host``: ``(name, start, end)`` of the runtime calls (launches,
      copies, synchronizations);
    * ``device``: ``(name, start, end, launch)`` of every kernel, copy and
      fill, ``launch`` the start of its runtime call (None: unmatched).
    """

    def __init__(self, spans, host, device):
        self.spans = spans
        self.host = host
        self.device = device

    @classmethod
    def from_kineto(cls, raw, spans) -> "TraceEvents":
        from torch.autograd import DeviceType

        host, dev, runtime = [], [], {}
        for e in raw:
            if e.is_user_annotation():
                continue
            if e.device_type() == DeviceType.CPU:
                rec = (e.name(), e.start_ns(), e.end_ns())
                host.append(rec)
                runtime[e.correlation_id()] = rec
            else:
                dev.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
        device = [(name, start, end, runtime[corr][1] if corr in runtime else None)
                  for name, start, end, corr in dev]
        return cls(list(spans), host, device)

    def window(self) -> tuple[int, int] | None:
        """The measured window's annotation, ``(start, end)``."""
        spans = [(s, e) for n, s, e in self.spans if n == WINDOW_RANGE]
        return spans[0] if spans else None

    def range_device_ns(self, name: str) -> tuple[int, float]:
        """``(calls, device ns)``: the spans of ``name`` and the device time
        of the kernels launched inside them."""
        spans = sorted((s, e) for n, s, e in self.spans if n == name)
        if not spans:
            return 0, 0.0
        # spans of one name do not nest: the candidate is the last to start
        starts = [s for s, _ in spans]
        total = 0.0
        for _, start, end, launch in self.device:
            if launch is None:
                continue
            i = bisect.bisect_right(starts, launch) - 1
            if i >= 0 and launch <= spans[i][1]:
                total += end - start
        return len(spans), total

    def busy_intervals(self, lo: int, hi: int) -> list:
        """The union of device activity clipped to ``[lo, hi]``, in order."""
        merged = []
        for _, s, e, _ in sorted(self.device, key=lambda d: d[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_ns(self) -> float | None:
        win = self.window()
        if win is None:
            return None
        return float(sum(e - s for s, e in self.busy_intervals(*win)))

    def top_device_ops(self, n: int = 10) -> list:
        win = self.window()
        totals: dict = {}
        for name, s, e, _ in self.device:
            if win is None or win[0] <= s <= win[1]:
                totals[name] = totals.get(name, 0) + (e - s)
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle time in the window, summed by what the host was
        doing at the start of each gap: the innermost span or runtime call
        open then, or ``python``."""
        win = self.window()
        if win is None:
            return []
        busy = self.busy_intervals(*win)
        edges = [win[0]] + [x for iv in busy for x in iv] + [win[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        # the host's spans nest: sweep them in start order with a stack,
        # whose top at a gap's start is the innermost span open then
        spans = sorted((s, -e, name) for name, s, e in self.host + self.spans
                       if name != WINDOW_RANGE)
        totals: dict = {}
        stack: list = []
        i = 0
        for gs, ge in gaps:
            while i < len(spans) and spans[i][0] <= gs:
                s, neg_e, name = spans[i]
                while stack and stack[-1][0] < s:
                    stack.pop()
                stack.append((-neg_e, name))
                i += 1
            while stack and stack[-1][0] < gs:
                stack.pop()
            name = stack[-1][1] if stack else "python"
            totals[name] = totals.get(name, 0) + (ge - gs)
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]
