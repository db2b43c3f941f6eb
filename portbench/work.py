"""The yardstick's arithmetic: the card's peaks and the work of each layer.

Every count here is what the inputs need, computed from shapes (and, for
the rulebook, from the active sites), never what a kernel happens to do:
a roofline share is the least time the card could take for that work
over the time measured, so it cannot pass 100% unless the count is too
high or the time leaves out part of the work.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# NVIDIA H100 SXM (data sheet, dense rates): float32 outside the tensor
# cores, and device memory bandwidth.  The `highest` tier runs IEEE float32.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

# bytes of one event slot as the integrate stage reads it: y, x, ts (int32)
# and the valid flag (bool) of an EventChunk
EVENT_SLOT_BYTES = 4 + 4 + 4 + 1


def conv_layers(layers: dict, frame_h: int, frame_w: int):
    """``(h_out, w_out, cin, cout, kh, kw)`` of each conv of a SAME-padded,
    stride-1 conv/pool chain whose pools are ``k x k`` stride ``k`` VALID."""
    h, w = frame_h, frame_w
    out = []
    for name, size in layers.items():
        if "conv" in name:
            kh, kw, cin, cout = size
            out.append((h, w, cin, cout, kh, kw))
        elif "pool" in name:
            h, w = h // size[0], w // size[1]
    return out


def frame_flops(layers: dict, frame_h: int, frame_w: int) -> int:
    """Multiply-adds (two operations each) of the dense convs on one frame;
    bias, activation and pools are not counted."""
    return sum(2 * h * w * cin * cout * kh * kw
               for h, w, cin, cout, kh, kw in conv_layers(layers, frame_h, frame_w))


def integrate_bytes(slots: int, surfaces: int, streams: int, pixels: int) -> int:
    """Least bytes of one parallel integrate call: every event slot read
    once, each stream's starting surface read once and every chunk-boundary
    surface written once (float32)."""
    return slots * EVENT_SLOT_BYTES + 4 * pixels * (surfaces + streams)


def least_seconds(flops: float, n_bytes: float) -> float:
    """The roofline: the larger of the compute time and the memory time."""
    return max(flops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES_S)


def rulebook_work(active: torch.Tensor, kh: int, kw: int, cin: int, cout: int):
    """``(flops, bytes)`` a stride-1 rulebook update of the ``active`` output
    sites needs, for both planes (featuremap with bias, and conv-actfn):
    each active site's taps over both planes, every input pixel of the
    padded planes that some active site reads (read once), the kernel and
    bias read once, each active site's two output vectors written once."""
    n_active = int(active.sum())
    if n_active == 0:
        return 0, 0
    m = F.pad(active.float()[None, None], (kw - 1, kw - 1, kh - 1, kh - 1))
    inputs = int(F.max_pool2d(m, (kh, kw), stride=1).sum())
    flops = 2 * 2 * n_active * kh * kw * cin * cout
    n_bytes = 4 * (2 * inputs * cin + kh * kw * cin * cout + cout + 2 * n_active * cout)
    return flops, n_bytes
