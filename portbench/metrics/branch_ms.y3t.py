"""Device ms a dispatch of the kernels launched inside the program's spans of
YOLOv3-tiny's 26x26 branch: ``layer.route17``, ``layer.conv18``,
``layer.upsample19``, ``layer.route20`` (the skip connection's
concatenation), ``layer.conv21`` and ``layer.conv22``."""

from portbench.program_spans import device_ms_per

SPANS = ("layer.route17", "layer.conv18", "layer.upsample19", "layer.route20",
         "layer.conv21", "layer.conv22")


def read(rec):
    return device_ms_per(rec, SPANS, "serve.dispatch")
