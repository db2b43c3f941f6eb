"""Device ms a dispatch of the kernels launched inside the program's
``layer.pool11`` .. ``layer.conv15`` spans: YOLOv3-tiny's deep 13x13 stage
behind the stride-1 pool, up to the first head."""

from portbench.program_spans import device_ms_per

SPANS = ("layer.pool11", "layer.conv12", "layer.conv13", "layer.conv14", "layer.conv15")


def read(rec):
    return device_ms_per(rec, SPANS, "serve.dispatch")
