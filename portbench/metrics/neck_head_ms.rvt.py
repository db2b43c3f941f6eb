"""Device ms a dispatch of the kernels launched inside the program's
``layer.<name>`` spans of the layers after the configuration's last LSTM:
YOLOX's PAFPN (its convs, CSP layers, upsampling and routes) and head (its
convs and the levels' outputs).  Nothing where the program records no
such span."""

from portbench.program_spans import device_ms_per, spans


def read(rec):
    names = list(rec.config.get("layers", {}))
    last = max((i for i, n in enumerate(names) if "lstm" in n), default=None)
    own = spans(rec)
    if last is None or not own:
        return None
    wanted = tuple(f"layer.{n}" for n in names[last + 1:])
    if not any(s[0] in wanted for s in own):
        return None
    return device_ms_per(rec, wanted, "serve.dispatch")
