"""Device ms a dispatch of the kernels launched inside the program's
``layer.conv1`` and ``layer.pool1`` spans: the direct stem that a fused
stem would replace (its epilogue is in ``epilogue_ms.replay`` too)."""

from portbench.program_spans import device_ms_per


def read(rec):
    return device_ms_per(rec, ("layer.conv1", "layer.pool1"), "serve.dispatch")
