"""Device ms a dispatch of the kernels launched inside the program's
``attn.window`` and ``attn.grid`` spans: RVT's window and grid attention
(pre-norm, QKV, the attention, the projection and LayerScale's residual)
in every stage's MaxViT pair.  Nothing where the program records no such
span."""

from portbench.program_spans import device_ms_per, spans

SPANS = ("attn.window", "attn.grid")


def read(rec):
    own = spans(rec)
    if not own or not any(s[0] in SPANS for s in own):
        return None
    return device_ms_per(rec, SPANS, "serve.dispatch")
