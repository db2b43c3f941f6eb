"""latency_p95_ms: the 95th percentile, over every request handed over in
the window (each waited for), of its completion (a CUDA event after the
request's outputs) less its due time (an open loop's schedule, or the
handover in a closed loop)."""

from portbench.readers import p95


def read(rec):
    v = p95([r.done - r.due for r in rec.requests if r.done is not None])
    return v * 1e3 if v is not None else None
