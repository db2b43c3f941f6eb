"""The least time of a dispatch's integrate work (every event slot read
once, every chunk-boundary surface written once, at the card's memory
bandwidth) over the integrate stage's device ms a dispatch.  The work is
the same whatever kernels do it."""

from portbench import work
from portbench.readers import INTEGRATE, range_ms_per_call

WRAP = [INTEGRATE]


def read(rec):
    ms = range_ms_per_call(rec, INTEGRATE[2])
    if not ms:
        return None
    cfg, mix = rec.config, rec.mix
    s, t, e = int(mix["streams"]), int(mix["chunks"]), int(mix["events_per_chunk"])
    channels = cfg["layers"][next(n for n in cfg["layers"] if "conv" in n)][2]
    n_bytes = work.integrate_bytes(s * t * e, s * t, s, channels * cfg["frame_h"] * cfg["frame_w"])
    return 100.0 * work.least_seconds(0, n_bytes) / (ms / 1e3)
