"""YOLO detection head: grid reshape and box decoding.

Counterpart of ``async_ev_cnn_tpu/models/head.py``: grid-cell offsets,
sqrt-encoded width/height and the ``[h_cells, w_cells, C + B*5]`` output
contract.  Runs on the tensor's device; leading batch axes broadcast, so
one call decodes every frame of a dispatch.

:func:`decode_yolov3` is the port's own: YOLOv3's anchor decode (Redmon &
Farhadi 2018, darknet's ``yolo`` layer) over the grids of several heads.
:func:`decode_yolox` is YOLOX's anchor-free decode (Ge et al. 2021), RVT's
head.
"""

from __future__ import annotations

import torch

from async_ev_cnn_torch.utils.profiling import span


def convert_bboxes(bboxes, grid_h: int, grid_w: int, h_image: int, w_image: int,
                   sqrt: bool = True):
    """Grid-relative box params -> image-space (x_center, y_center, w, h).

    ``bboxes``: ``[..., grid_h, grid_w, B, 4]`` with (x, y, w, h) in cell
    units; w/h are sqrt-encoded when ``sqrt``.  Leading axes broadcast.
    """
    b = torch.as_tensor(bboxes, dtype=torch.float32)
    col_idx = torch.arange(grid_w, dtype=torch.float32, device=b.device).reshape(grid_w, 1)
    row_idx = torch.arange(grid_h, dtype=torch.float32, device=b.device).reshape(grid_h, 1, 1)
    true_x = (b[..., 0] + col_idx) / grid_w * w_image
    true_y = (b[..., 1] + row_idx) / grid_h * h_image
    true_w = (torch.square(b[..., 2]) if sqrt else b[..., 2]) * w_image
    true_h = (torch.square(b[..., 3]) if sqrt else b[..., 3]) * h_image
    return torch.stack([true_x, true_y, true_w, true_h], dim=-1)


def decode(grid_out, num_classes: int, num_bbox: int, h_image: int,
           w_image: int, sqrt: bool = True):
    """Decode ``[..., h_cells, w_cells, C + B*5]`` grids into detections.

    Returns ``(boxes [..., N, 4] xywh in pixels, scores [..., N],
    class_probs [..., N, C])`` with ``N = h_cells * w_cells * B``; for one
    grid, exactly the JAX package's ``decode``.  Class probs are the cell's
    class distribution scaled by box confidence.
    """
    g = torch.as_tensor(grid_out, dtype=torch.float32)
    lead = g.shape[:-3]
    h_cells, w_cells = g.shape[-3], g.shape[-2]
    cls = g[..., :num_classes]
    box = g[..., num_classes:].reshape(*lead, h_cells, w_cells, num_bbox, 5)
    boxes = convert_bboxes(
        box[..., :4], h_cells, w_cells, h_image, w_image, sqrt
    ).reshape(*lead, -1, 4)
    conf = box[..., 4]
    scores = conf.reshape(*lead, -1)
    probs = (cls[..., None, :] * conf[..., None]).reshape(*lead, -1, num_classes)
    return boxes, scores, probs


def decode_yolov3(grids, anchors, masks, h_image: int, w_image: int):
    """Decode YOLOv3 heads into detections, on the grids' device.

    ``grids`` are the heads' ``[..., gh, gw, A * (5 + C)]`` outputs,
    anchor-major over the last axis (darknet's channel order); ``anchors``
    the ``(w, h)`` anchor sizes in input pixels and ``masks`` the anchors
    of each head (``A`` each).  A cell's box is centred at ``((col +
    sigmoid(tx)) / gw * w_image, (row + sigmoid(ty)) / gh * h_image)``
    with size ``(exp(tw) * aw, exp(th) * ah)`` pixels; its objectness is
    ``sigmoid(to)`` and each class score ``sigmoid(tc)`` times it.

    Returns ``(boxes [..., N, 4]`` centre x, centre y, width, height in
    pixels, ``scores [..., N]``, ``class_probs [..., N, C])`` with the
    heads in order and each head's boxes by row, column and anchor:
    ``N = sum(gh * gw * A)``.
    """
    boxes, scores, probs = [], [], []
    with span("head.yolo"):
        for grid, mask in zip(grids, masks):
            g = torch.as_tensor(grid, dtype=torch.float32)
            lead, (gh, gw) = g.shape[:-3], g.shape[-3:-1]
            p = g.reshape(*lead, gh, gw, len(mask), -1)
            col = torch.arange(gw, dtype=torch.float32, device=g.device).reshape(gw, 1)
            row = torch.arange(gh, dtype=torch.float32, device=g.device).reshape(gh, 1, 1)
            xy = torch.sigmoid(p[..., :2])
            # the anchor sizes are Python scalars: no tensor crosses to the card
            wh = torch.stack([torch.stack([p[..., a, 2].exp() * anchors[m][0],
                                           p[..., a, 3].exp() * anchors[m][1]], dim=-1)
                              for a, m in enumerate(mask)], dim=-2)
            obj = torch.sigmoid(p[..., 4])
            boxes.append(torch.stack([(xy[..., 0] + col) / gw * w_image,
                                      (xy[..., 1] + row) / gh * h_image,
                                      wh[..., 0], wh[..., 1]], dim=-1).reshape(*lead, -1, 4))
            scores.append(obj.reshape(*lead, -1))
            cls = torch.sigmoid(p[..., 5:]) * obj[..., None]
            probs.append(cls.reshape(*lead, -1, cls.shape[-1]))
        return torch.cat(boxes, dim=-2), torch.cat(scores, dim=-1), torch.cat(probs, dim=-2)


def decode_yolox(grids, strides):
    """Decode YOLOX levels into detections, on the grids' device.

    ``grids`` are the levels' raw ``[..., gh, gw, 4 + 1 + C]`` outputs (box
    ``(x, y, w, h)`` regressions, objectness and class logits, the
    network's ``yolox`` layers), ``strides`` their input pixels a cell.  A
    cell's box is centred at ``((tx + col) * stride, (ty + row) * stride)``
    with size ``(exp(tw) * stride, exp(th) * stride)``; its score is
    ``sigmoid(obj)`` and each class score ``sigmoid(cls) * sigmoid(obj)``.

    Returns ``(boxes [..., N, 4]`` centre x, centre y, width, height in
    pixels, ``scores [..., N]``, ``class_probs [..., N, C])`` with the
    levels in order and each level's cells by row and column: ``N =
    sum(gh * gw)``.
    """
    boxes, scores, probs = [], [], []
    with span("head.yolox"):
        for grid, stride in zip(grids, strides):
            g = torch.as_tensor(grid, dtype=torch.float32)
            lead, (gh, gw) = g.shape[:-3], g.shape[-3:-1]
            col = torch.arange(gw, dtype=torch.float32, device=g.device).reshape(gw)
            row = torch.arange(gh, dtype=torch.float32, device=g.device).reshape(gh, 1)
            # the stride is a Python scalar: no tensor crosses to the card
            wh = g[..., 2:4].exp() * stride
            obj = torch.sigmoid(g[..., 4])
            boxes.append(torch.stack([(g[..., 0] + col) * stride, (g[..., 1] + row) * stride,
                                      wh[..., 0], wh[..., 1]], dim=-1).reshape(*lead, -1, 4))
            scores.append(obj.reshape(*lead, -1))
            cls = torch.sigmoid(g[..., 5:]) * obj[..., None]
            probs.append(cls.reshape(*lead, -1, cls.shape[-1]))
        return torch.cat(boxes, dim=-2), torch.cat(scores, dim=-1), torch.cat(probs, dim=-2)
