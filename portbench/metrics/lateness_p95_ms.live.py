"""How late the open-loop generator handed items over against their due
time: the 95th percentile, in ms."""

from portbench.readers import p95, untraced


def read(rec):
    v = p95(untraced(rec)[1])
    return v * 1e3 if v is not None else None
