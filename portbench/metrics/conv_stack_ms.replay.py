"""Device ms a dispatch of the kernels launched inside the conv stack
(``EventNetwork.full_frame_forward``)."""

from portbench.readers import CONV_STACK, range_ms_per_call

WRAP = [CONV_STACK]


def read(rec):
    return range_ms_per_call(rec, CONV_STACK[2])
