"""The program's ``host.sync`` spans (each a read or copy on which the host
waits for the card) over the chunks handed over while the trace ran."""

from portbench.program_spans import per_chunk


def read(rec):
    return per_chunk(rec, "host.sync")
