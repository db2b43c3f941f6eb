"""The least time of a dispatch's LSTM gate updates (each pixel's gates
read once, its cell read and written, its hidden map written, at the
card's memory bandwidth: ``work_rvt.lstm_gate_bytes`` a frame, the mix's
streams x chunks frames a dispatch) over the device ms a dispatch of the
kernels launched inside the program's ``lstm.gates`` spans: the gate
kernel G1.  Nothing where the program records no such span."""

from portbench import work, work_rvt
from portbench.program_spans import device_ms_per, spans


def read(rec):
    own = spans(rec)
    if not own or not any(s[0] == "lstm.gates" for s in own):
        return None
    ms = device_ms_per(rec, ("lstm.gates",), "serve.dispatch")
    if not ms:
        return None
    cfg, mix = rec.config, rec.mix
    frames = int(mix["streams"]) * int(mix["chunks"])
    n_bytes = work_rvt.lstm_gate_bytes(cfg["layers"], cfg["frame_h"], cfg["frame_w"]) * frames
    return 100.0 * work.least_seconds(0, n_bytes) / (ms / 1e3)
