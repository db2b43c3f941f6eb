"""Median host ms a dispatch in the program's ``serve.admit`` span: the
items' rebase, wire packing and tier unification, read in the traced
half."""

from portbench.program_spans import host_ms_per_request


def read(rec):
    return host_ms_per_request(rec, "serve.admit")
