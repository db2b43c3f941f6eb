"""The work of a network that is a small graph (YOLOv3-tiny): the dense
operations of its convs on one frame, from a shape walk that honours pool
strides, routes and upsampling.

``work.conv_layers`` assumes a chain whose pools stride by their size; it
stays right for the eFCN, and :func:`frame_flops` agrees with it there.
The layers are a configuration's ``layers``: ``convN: [kh, kw, cin,
cout]``, ``poolN: [kh, kw]`` (stride kh) or ``[kh, kw, stride]`` (a stride
below the size pads to ``ceil(size / stride)``), ``upsampleN: [factor]``,
``routeN: [names]`` (channels concatenated) and ``yoloN: [name]`` (an
output; it changes no shape).
"""

from __future__ import annotations


def conv_shapes(layers: dict, frame_h: int, frame_w: int, channels: int = 1):
    """``(h, w, cin, cout, kh, kw)`` of each stride-1 SAME conv of the graph."""
    shape = (channels, frame_h, frame_w)
    named, out = {}, []
    for name, size in layers.items():
        c, h, w = shape
        if "route" in name:
            parts = [named[s] for s in size]
            shape = (sum(p[0] for p in parts), *parts[0][1:])
        elif "upsample" in name:
            shape = (c, h * size[0], w * size[0])
        elif "yolo" in name:
            pass
        elif "conv" in name:
            kh, kw, cin, cout = size
            out.append((h, w, cin, cout, kh, kw))
            shape = (cout, h, w)
        elif "pool" in name:
            stride = size[2] if len(size) > 2 else size[0]
            if stride < min(size[:2]):
                shape = (c, -(-h // stride), -(-w // stride))
            else:
                shape = (c, (h - size[0]) // stride + 1, (w - size[1]) // stride + 1)
        else:
            raise ValueError(f"no layer kind in the name {name!r}")
        named[name] = shape
    return out


def frame_flops(layers: dict, frame_h: int, frame_w: int) -> int:
    """Multiply-adds (two operations each) of the dense convs on one frame;
    bias, batch norm, activation, pools, routes and upsampling are not
    counted."""
    return sum(2 * h * w * cin * cout * kh * kw
               for h, w, cin, cout, kh, kw in conv_shapes(layers, frame_h, frame_w))
