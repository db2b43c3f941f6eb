"""The least time of a dispatch's LayerNorm passes (every float32 of the
tokens read once and written once, at the card's memory bandwidth:
``work_rvt.layer_norm_bytes`` a frame, the mix's streams x chunks frames a
dispatch) over the device ms a dispatch of the kernels launched inside
the program's ``norm.l1`` spans: the LayerNorm kernel L1.  Nothing where
the program records no such span."""

from portbench import work, work_rvt
from portbench.program_spans import device_ms_per, spans


def read(rec):
    own = spans(rec)
    if not own or not any(s[0] == "norm.l1" for s in own):
        return None
    ms = device_ms_per(rec, ("norm.l1",), "serve.dispatch")
    if not ms:
        return None
    cfg, mix = rec.config, rec.mix
    frames = int(mix["streams"]) * int(mix["chunks"])
    n_bytes = work_rvt.layer_norm_bytes(cfg["layers"], cfg["frame_h"], cfg["frame_w"]) * frames
    return 100.0 * work.least_seconds(0, n_bytes) / (ms / 1e3)
