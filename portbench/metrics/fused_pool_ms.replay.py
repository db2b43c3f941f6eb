"""Device ms a dispatch of the kernels launched inside the program's
``conv.fused_pool`` spans: the fused conv + pool C1 on the 2x2-pooled 3x3
convs that are not the stem (conv2-conv5 of the eFCN).  Nothing where the
program records no such span (a checkout without C1)."""

from portbench.program_spans import device_ms_per, spans


def read(rec):
    own = spans(rec)
    if not own or not any(s[0] == "conv.fused_pool" for s in own):
        return None
    return device_ms_per(rec, ("conv.fused_pool",), "serve.dispatch")
