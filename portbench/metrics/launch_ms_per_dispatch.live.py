"""Median host ms a dispatch in the program's ``serve.dispatch`` span: the
upload, unpack, integrate, conv stack and head enqueued on the card, read
in the traced half."""

from portbench.program_spans import host_ms_per_request


def read(rec):
    return host_ms_per_request(rec, "serve.dispatch")
