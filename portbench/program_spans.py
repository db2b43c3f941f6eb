"""What the metric files that read the program's own spans share.

The port records spans at its layer boundaries while a ``torch.profiler``
session runs (``async_ev_cnn_torch.utils.profiling``: ``span``,
``recorded``), on the host clock of the profiler's records.  A traced run's
spans are those that overlap its window.  They form a
:class:`~portbench.tracing.TraceEvents` with the harness's window and
source spans and the trace's device records, so the trace's own arithmetic
(device time a span, idle gaps by the span open at their start) reads
them.  Where the program records no spans (a checkout without the
recorder), or the run was not traced on the card, every reader returns
None.
"""

from __future__ import annotations

import statistics

from portbench.tracing import SOURCE_RANGE, WINDOW_RANGE, TraceEvents


def spans(rec):
    """The program's spans that overlap the traced window, as its recorder
    gives them (``(name, start_ns, end_ns, parent, request, thread)``), or
    None."""
    if rec.trace is None or not rec.trace.device or rec.trace.window() is None:
        return None
    try:
        from async_ev_cnn_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    lo, hi = rec.trace.window()
    return [s for s in recorded() if s[1] <= hi and s[2] >= lo]


def events(rec) -> TraceEvents | None:
    """The program's spans of the window, the harness's window and source
    spans and the trace's device records, as one :class:`TraceEvents` (no
    runtime calls: a gap is named by a span or not at all)."""
    own = spans(rec)
    if own is None:
        return None
    harness = [s for s in rec.trace.spans if s[0] in (WINDOW_RANGE, SOURCE_RANGE)]
    return TraceEvents([s[:3] for s in own] + harness, [], rec.trace.device)


def device_ms_per(rec, names, per: str):
    """Device ms of the kernels launched inside the spans ``names``, over
    the number of ``per`` spans (a dispatch's, for ``serve.dispatch``)."""
    ev = events(rec)
    if ev is None:
        return None
    calls = sum(1 for s in ev.spans if s[0] == per)
    if not calls:
        return None
    return sum(ev.range_device_ns(name)[1] for name in names) / 1e6 / calls


def host_ms_per_request(rec, name: str):
    """The median host ms a request (a dispatch) spends in spans ``name``."""
    own = spans(rec)
    if own is None:
        return None
    total: dict = {}
    for n, t0, t1, _, request, _ in own:
        if n == name:
            total[request] = total.get(request, 0) + (t1 - t0)
    return statistics.median(total.values()) / 1e6 if total else None


def per_chunk(rec, name: str):
    """Spans ``name`` over the chunks handed over while the trace ran."""
    own = spans(rec)
    chunks = len(rec.requests) - (rec.trace_from or 0)
    if own is None or chunks <= 0:
        return None
    return sum(1 for s in own if s[0] == name) / chunks


def idle_unnamed_share(rec):
    """The share of the card's idle time in the window at whose start
    neither a program span nor the harness's source span was open."""
    ev = events(rec)
    if ev is None:
        return None
    gaps = ev.idle_gaps(n=len(ev.spans) + 1)
    idle = sum(s for _, s in gaps)
    return 100.0 * sum(s for n, s in gaps if n == "python") / idle if idle else None
