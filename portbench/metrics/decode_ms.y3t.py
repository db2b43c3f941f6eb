"""Device ms a dispatch of the kernels launched inside the program's
``head.yolo`` span: the YOLOv3 decode of both heads on the card."""

from portbench.program_spans import device_ms_per


def read(rec):
    return device_ms_per(rec, ("head.yolo",), "serve.dispatch")
