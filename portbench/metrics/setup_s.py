"""setup_s: process start to the window's start: imports, the card, the
kernels (built on a checkout's first run), weights, traffic, warm-up."""


def read(rec):
    return rec.setup_s
