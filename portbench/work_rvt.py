"""The work of a network with RVT's layers: the dense operations of one
frame, from a shape walk over a configuration's ``layers`` that knows
every token of the port's layer DSL.

``work_graph`` walks the convs, pools, routes, upsampling and ``yolo``
outputs of YOLOv3-tiny; this walk knows those too (and agrees with it
there, and with ``work.conv_layers`` on the eFCN) and RVT's:

* ``embedN: [kh, kw, cin, cout, stride]``: a conv padded ``k // 2`` a
  side at ``stride`` (its LayerNorm is not counted);
* ``attnN: [dim, dim_head, ph, pw, mlp_ratio]``: two halves (window,
  grid), each the QKV projection (``3 dim`` outputs), the scores and the
  weighted sum over each ``ph x pw`` partition (``L = ph * pw`` keys a
  query, every head: ``2 L dim`` multiply-adds a token), the output
  projection and the MLP's two Linears (softmax, GELU, LayerNorm and
  LayerScale not counted);
* ``lstmN: [dim]``: the 1x1 conv over ``cat(x, h)``, ``2 dim -> 4 dim``
  (the gate update not counted);
* ``cspN: [cin, cout, n]``: two 1x1 convs to ``cout / 2``, ``n``
  bottlenecks (1x1 and 3x3 at ``cout / 2``), a 1x1 conv from ``cout``;
* ``convN: [kh, kw, cin, cout]`` or ``[..., stride]``; ``yoloxN``: an
  output, like ``yolo`` (no work).

A multiply-add counts two operations; biases, batch norm and
activations are not counted.
"""

from __future__ import annotations


def walk(layers: dict, frame_h: int, frame_w: int, channels: int = 1):
    """``(name, size, in_shape, out_shape)`` of each layer, shapes ``(C, H,
    W)``: the maps it reads and writes (a ``yolo`` or ``yoloxN`` layer writes
    none; the next layer reads what it read)."""
    shape, named = (channels, frame_h, frame_w), {}
    for name, size in layers.items():
        c, h, w = shape
        out = shape
        if "route" in name:
            parts = [named[s] for s in size]
            out = (sum(p[0] for p in parts), *parts[0][1:])
        elif "upsample" in name:
            out = (c, h * size[0], w * size[0])
        elif "yolo" in name or "attn" in name or "lstm" in name:
            pass
        elif "embed" in name:
            kh, kw, _, cout, stride = size
            out = (cout, (h + 2 * (kh // 2) - kh) // stride + 1,
                   (w + 2 * (kw // 2) - kw) // stride + 1)
        elif "csp" in name:
            out = (size[1], h, w)
        elif "conv" in name:
            stride = size[4] if len(size) > 4 else 1
            out = (size[3], -(-h // stride), -(-w // stride))
        elif "pool" in name:
            stride = size[2] if len(size) > 2 else size[0]
            if stride < min(size[:2]):
                out = (c, -(-h // stride), -(-w // stride))
            else:
                out = (c, (h - size[0]) // stride + 1, (w - size[1]) // stride + 1)
        else:
            raise ValueError(f"no layer kind in the name {name!r}")
        yield name, size, shape, out
        named[name] = shape = out


def _flops(name, size, in_shape, out_shape) -> int:
    c, h, w = in_shape
    if "embed" in name or "conv" in name:
        kh, kw, cin, cout = size[:4]
        return 2 * out_shape[1] * out_shape[2] * cin * cout * kh * kw
    if "attn" in name:
        dim, _, ph, pw, ratio = size
        per_half = 3 * dim * dim + 2 * ph * pw * dim + dim * dim + 2 * ratio * dim * dim
        return 2 * 2 * h * w * per_half
    if "lstm" in name:
        return 2 * h * w * (2 * c) * (4 * c)
    if "csp" in name:
        cin, cout, depth = size
        hid = cout // 2
        return 2 * h * w * (2 * cin * hid + depth * (hid * hid + 9 * hid * hid) + 2 * hid * cout)
    return 0


def layer_flops(layers: dict, frame_h: int, frame_w: int, channels: int = 1) -> dict:
    """Each layer's operations on one frame, by name, in order."""
    return {step[0]: _flops(*step) for step in walk(layers, frame_h, frame_w, channels)}


def frame_flops(layers: dict, frame_h: int, frame_w: int, channels: int = 1) -> int:
    """The dense operations of one frame."""
    return sum(layer_flops(layers, frame_h, frame_w, channels).values())


def layer_norm_bytes(layers: dict, frame_h: int, frame_w: int, channels: int = 1) -> int:
    """Least bytes of one frame's passes through the LayerNorm kernel L1
    (``ops/layer_norm.py``): each token of an embedding's map once (its
    LayerNorm), and of a pair's four times (the window half's partition,
    the grid half's norm and partition, the two MLPs' norms), each pass
    reading every float32 once and writing it once.  The scales and shifts
    are not counted."""
    passes = {"embed": 1, "attn": 4}
    return sum(passes[k] * 2 * 4 * c * h * w
               for name, _, _, (c, h, w) in walk(layers, frame_h, frame_w, channels)
               for k in passes if k in name)


def lstm_gate_bytes(layers: dict, frame_h: int, frame_w: int, channels: int = 1) -> int:
    """Least bytes of one frame's gate updates by the kernel G1
    (``ops/lstm_gates.py``), one an LSTM a frame: each pixel's four gates
    read once, its cell read and written, its hidden map written, 28 C
    bytes a pixel of a C-channel LSTM."""
    return sum(28 * c * h * w for name, _, (c, h, w), _ in walk(layers, frame_h, frame_w,
                                                                channels) if "lstm" in name)
