"""YOLO detection head: grid reshape and box decoding.

Counterpart of ``async_ev_cnn_tpu/models/head.py``: grid-cell offsets,
sqrt-encoded width/height and the ``[h_cells, w_cells, C + B*5]`` output
contract.  Runs on the tensor's device; leading batch axes broadcast, so
one call decodes every frame of a dispatch.
"""

from __future__ import annotations

import torch


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
