"""The dense operations on every frame completed in the (untraced part of
the) window, as a share of the card's float32 peak (67 TFLOP/s); the
operations of a frame from the shape walk that knows RVT's layers
(``work_rvt``: 29,428,776,960 for RVT-B on a 1-channel 384x640 surface:
the convs, the attention's projections, scores and weighted sums, the
MLPs and the LSTMs' 1x1 convs)."""

from portbench import work, work_rvt
from portbench.readers import untraced


def read(rec):
    cfg = rec.config
    _, _, seconds, t_end = untraced(rec)
    frames = sum(r.frames for r in rec.requests if r.done is not None and r.done <= t_end)
    if not frames or seconds <= 0:
        return None
    flops = work_rvt.frame_flops(cfg["layers"], cfg["frame_h"], cfg["frame_w"]) * frames
    return 100.0 * flops / seconds / work.PEAK_F32_FLOPS
