"""Device ms a dispatch of the kernels launched inside the integrate stage
(``integrate_parallel``: the winner dedup and K1)."""

from portbench.readers import INTEGRATE, range_ms_per_call

WRAP = [INTEGRATE]


def read(rec):
    return range_ms_per_call(rec, INTEGRATE[2])
