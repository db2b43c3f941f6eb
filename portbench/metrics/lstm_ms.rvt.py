"""Device ms a dispatch of the kernels launched inside the program's
``lstm.input`` and ``lstm.scan`` spans: RVT's ConvLSTMs, the input half's
GEMM over a block of time steps and the sequential steps (the hidden
half's GEMM and the gate update).  Nothing where the program records no
such span."""

from portbench.program_spans import device_ms_per, spans

SPANS = ("lstm.input", "lstm.scan")


def read(rec):
    own = spans(rec)
    if not own or not any(s[0] in SPANS for s in own):
        return None
    return device_ms_per(rec, SPANS, "serve.dispatch")
