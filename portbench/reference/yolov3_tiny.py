"""Plain reference of YOLOv3-tiny (Redmon & Farhadi, "YOLOv3: An Incremental
Improvement", arXiv:1804.02767; darknet's ``cfg/yolov3-tiny.cfg``).

Straightforward PyTorch of the published network, layer by layer in
darknet's order, float32 with TF32 off in cuDNN and cuBLAS (unless
``use_tf32``, the control of the benchmark).  It imports nothing of the
port nor of the JAX package, and shares no code with them:

* ``[convolutional]``: a ``size x size`` stride-1 conv padded by
  ``size // 2`` on every side (darknet's ``pad=1``); with
  ``batch_normalize=1`` no bias and darknet's batch norm, ``(x - mean) /
  (sqrt(var) + 1e-6) * gamma + beta``; else a bias; then ``leaky``
  (``x > 0 ? x : 0.1 * x``) or ``linear``;
* ``[maxpool]``: darknet pads ``size - 1`` and starts the windows at
  ``-padding / 2`` (integer division), so the stride-1 pool's windows run
  past the right and bottom edges, where darknet's initial ``-FLT_MAX``
  stands (here ``-inf``); the stride-2 pools meet no edge on even maps;
* ``[route]``: one earlier layer's output, or several concatenated over
  channels in the order listed;
* ``[upsample] stride=2``: nearest neighbour;
* ``[yolo]``: its input is the head's output; :func:`decode` applies
  YOLOv3's logistic and exponential box decode.

Departures from the published network, each forced by the event camera or
by the comparison:

* the input is one channel, the leaky event surface (polarity dropped, as
  in the eFCN of Cannici et al. 2019), in place of RGB's three; darknet's
  letterbox resize and scaling of the image are left out: the surface is
  the network's 416 x 416 input;
* the weights are the caller's (seeded), not the trained COCO weights;
* the decode gives box centres and sizes in input pixels and every box of
  every cell (no threshold, no NMS: those are the caller's);
* the stride-2 pools assume even maps (every map of the published network
  at 416 x 416, and at any input divisible by 32).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

#: darknet's batch-norm epsilon, added to the standard deviation
BN_EPS = 1e-6
#: darknet's leaky slope
LEAKY = 0.1
ANCHORS = [(10, 14), (23, 27), (37, 58), (81, 82), (135, 169), (344, 319)]
#: the anchors of the 13x13 head and of the 26x26 head
MASKS = [(3, 4, 5), (1, 2, 3)]


def darknet_layers(classes: int = 80, anchors_per_head: int = 3, div: int = 1,
                   channels: int = 1) -> list[dict]:
    """``cfg/yolov3-tiny.cfg`` as a list of layers, index for index;
    ``div`` divides every width but the heads' (a small copy for tests),
    ``channels`` is the input's."""
    head = anchors_per_head * (5 + classes)

    def conv(filters, size, bn=True):
        return {"kind": "conv", "filters": filters, "size": size, "bn": bn,
                "act": "leaky" if bn else "linear"}

    def pool(stride):
        return {"kind": "maxpool", "size": 2, "stride": stride}

    layers = []
    for f in (16, 32, 64, 128, 256):  # layers 0-9
        layers += [conv(f // div, 3), pool(2)]
    layers += [conv(512 // div, 3), pool(1),  # 10, 11
               conv(1024 // div, 3), conv(256 // div, 1), conv(512 // div, 3),  # 12-14
               conv(head, 1, bn=False), {"kind": "yolo", "mask": MASKS[0]},  # 15, 16
               {"kind": "route", "layers": [13]}, conv(128 // div, 1),  # 17, 18
               {"kind": "upsample", "stride": 2}, {"kind": "route", "layers": [19, 8]},
               conv(256 // div, 3), conv(head, 1, bn=False),  # 21, 22
               {"kind": "yolo", "mask": MASKS[1]}]  # 23
    c = channels
    outs = []
    for layer in layers:  # each conv's input channels, as darknet infers them
        if layer["kind"] == "conv":
            layer["in"] = c
            c = layer["filters"]
        elif layer["kind"] == "route":
            c = sum(outs[j] for j in layer["layers"])
        outs.append(c)
    return layers


@contextlib.contextmanager
def tf32(enabled: bool):
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def forward(surfaces: torch.Tensor, weights: dict, layers: list[dict],
            use_tf32: bool = False) -> list[torch.Tensor]:
    """``[N, C, H, W]`` surfaces -> each yolo layer's output, channels last
    (``[N, gh, gw, A * (5 + classes)]``), in order.  ``weights`` holds, for
    conv ``i``, ``w_conv<i>`` (``[out, in, k, k]``) and either
    ``gamma_/beta_/mean_/var_conv<i>`` (batch norm) or ``b_conv<i>``."""
    routed = {j for layer in layers if layer["kind"] == "route" for j in layer["layers"]}
    x = surfaces.float()
    kept, heads = {}, []
    with tf32(use_tf32):
        for i, layer in enumerate(layers):
            kind = layer["kind"]
            if kind == "conv":
                x = F.conv2d(x, weights[f"w_conv{i}"], padding=layer["size"] // 2)
                if layer["bn"]:
                    def per_channel(name):
                        return weights[f"{name}_conv{i}"].reshape(1, -1, 1, 1)
                    x = ((x - per_channel("mean")) / (per_channel("var").sqrt() + BN_EPS)
                         * per_channel("gamma") + per_channel("beta"))
                else:
                    x = x + weights[f"b_conv{i}"].reshape(1, -1, 1, 1)
                if layer["act"] == "leaky":
                    x = torch.where(x > 0, x, LEAKY * x)
            elif kind == "maxpool":
                k, s = layer["size"], layer["stride"]
                if s == 1:
                    x = F.pad(x, (0, k - 1, 0, k - 1), value=float("-inf"))
                x = F.max_pool2d(x, k, s)
            elif kind == "yolo":
                heads.append(x.permute(0, 2, 3, 1))
            elif kind == "route":
                x = torch.cat([kept[j] for j in layer["layers"]], dim=1)
            elif kind == "upsample":
                x = F.interpolate(x, scale_factor=layer["stride"], mode="nearest")
            else:
                raise ValueError(f"the reference has no layer like {kind!r}")
            if i in routed:
                kept[i] = x
    return heads


def decode(heads, anchors, masks, h: int, w: int):
    """Each head's ``[N, gh, gw, A * (5 + classes)]`` output, darknet's
    channels ``a * (5 + classes) + k``, -> ``(boxes [N, B, 4]`` centre x,
    centre y, width, height in pixels, ``objectness [N, B]``, ``class
    scores [N, B, classes])``, the heads in order and each head's boxes by
    row, column and anchor: ``x = (col + sigmoid(tx)) / gw * w``, ``y =
    (row + sigmoid(ty)) / gh * h``, ``bw = exp(tw) * anchor_w``, ``bh =
    exp(th) * anchor_h``, objectness ``sigmoid(to)``, class score
    ``sigmoid(tc) * objectness``."""
    boxes, objs, scores = [], [], []
    for out, mask in zip(heads, masks):
        n, gh, gw, ch = out.shape
        p = out.float().reshape(n, gh, gw, len(mask), ch // len(mask))
        dev = p.device
        col = torch.arange(gw, device=dev, dtype=torch.float32).reshape(1, 1, gw, 1)
        row = torch.arange(gh, device=dev, dtype=torch.float32).reshape(1, gh, 1, 1)
        aw = torch.tensor([float(anchors[m][0]) for m in mask], device=dev)
        ah = torch.tensor([float(anchors[m][1]) for m in mask], device=dev)
        x = (col + torch.sigmoid(p[..., 0])) / gw * w
        y = (row + torch.sigmoid(p[..., 1])) / gh * h
        bw = torch.exp(p[..., 2]) * aw
        bh = torch.exp(p[..., 3]) * ah
        obj = torch.sigmoid(p[..., 4])
        boxes.append(torch.stack([x, y, bw, bh], dim=-1).reshape(n, -1, 4))
        objs.append(obj.reshape(n, -1))
        scores.append((torch.sigmoid(p[..., 5:]) * obj[..., None]).reshape(n, -1, ch // len(mask) - 5))
    return torch.cat(boxes, 1), torch.cat(objs, 1), torch.cat(scores, 1)
