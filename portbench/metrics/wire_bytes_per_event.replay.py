"""Bytes that crossed to the card an event: the pipeline's own counters."""


def read(rec):
    events = rec.counters.get("events")
    return rec.counters["wire_bytes"] / events if events else None
