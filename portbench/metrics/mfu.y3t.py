"""The dense convs' operations on every frame completed in the (untraced part
of the) window, as a share of the card's float32 peak (67 TFLOP/s); the
operations of a frame from the graph's shape walk (``work_graph``:
5,465,281,536 for YOLOv3-tiny on a 1-channel 416x416 surface)."""

from portbench import work, work_graph
from portbench.readers import untraced


def read(rec):
    cfg = rec.config
    _, _, seconds, t_end = untraced(rec)
    frames = sum(r.frames for r in rec.requests if r.done is not None and r.done <= t_end)
    if not frames or seconds <= 0:
        return None
    flops = work_graph.frame_flops(cfg["layers"], cfg["frame_h"], cfg["frame_w"]) * frames
    return 100.0 * flops / seconds / work.PEAK_F32_FLOPS
