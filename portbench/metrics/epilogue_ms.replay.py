"""Device ms a dispatch of the kernels launched inside the program's
``conv.bias``, ``conv.leaky`` and ``pool.max`` spans: the passes over each
conv's output after cuDNN's conv, which an epilogue fused into it would
save."""

from portbench.program_spans import device_ms_per


def read(rec):
    return device_ms_per(rec, ("conv.bias", "conv.leaky", "pool.max"), "serve.dispatch")
