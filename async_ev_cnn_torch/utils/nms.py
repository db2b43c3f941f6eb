"""Non-maximum suppression: host (numpy) and on-device (torch) variants.

Counterpart of ``async_ev_cnn_tpu/utils/nms.py``.  :func:`nms` and
:func:`apply_nms` are copied (host numpy, the reference's
``apply_nms`` convention over center-format boxes with a validity mask,
returning batch/box index pairs); :func:`nms_torch` is the counterpart of
``nms_jax``: a fixed-shape masked greedy NMS on the boxes' device.  All
three rank by a stable descending sort, so ties keep their index order and
the host and device paths pick the same representatives.
"""

from __future__ import annotations

import numpy as np
import torch


def _iou_center(box, boxes):
    """IoU of one (x, y, w, h) center-format box against [N, 4] — the 1xM
    case of :func:`async_ev_cnn_torch.utils.evaluation.iou_matrix`."""
    from async_ev_cnn_torch.utils.evaluation import iou_matrix

    return iou_matrix(np.asarray(box, np.float32)[None], boxes)[0]


def nms(boxes, scores, valid=None, iou_threshold=0.5):
    """Greedy NMS over one image's ``[N, 4]`` center-format boxes.

    Returns the selected indices (into the original array), highest score
    first.
    """
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    idx = np.argsort(-scores, kind="stable")
    if valid is not None:
        # a 0/1 int mask would fancy-index (selecting wrong boxes) —
        # force the boolean-mask interpretation
        idx = idx[np.asarray(valid, bool)[idx]]
    picked = []
    alive = list(idx)
    while alive:
        best = alive.pop(0)
        picked.append(best)
        if not alive:
            break
        rest = np.array(alive)
        iou = _iou_center(boxes[best], boxes[rest])
        alive = [i for i, v in zip(alive, iou) if v < iou_threshold]
    return np.array(picked, np.int64)


def apply_nms(batch_bboxes, batch_scores, batch_valid=None, iou_threshold=0.5):
    """Batched NMS with the reference's return convention
    (utils.py:38-118): ``[batch_indices, box_indices]`` arrays."""
    batch_bboxes = np.asarray(batch_bboxes)
    if batch_valid is None:
        batch_valid = [None] * batch_bboxes.shape[0]
    idx0, idx1 = [], []
    for b, (boxes, scores, valid) in enumerate(zip(batch_bboxes, batch_scores, batch_valid)):
        picked = nms(boxes, scores, valid, iou_threshold)
        idx0.extend([b] * len(picked))
        idx1.extend(picked.tolist())
    return [np.asarray(idx0, np.int64), np.asarray(idx1, np.int64)]


def nms_torch(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
              iou_threshold: float = 0.5) -> torch.Tensor:
    """Greedy NMS on the tensors' device: returns a keep mask ``[N]``.

    ``boxes`` ``[N, 4]`` center-format, ``scores`` ``[N]``, ``valid`` bool
    ``[N]``.  It walks the N score-sorted boxes once, keeping a box when it
    is valid and overlaps no kept higher-ranked box at ``iou_threshold`` or
    more — static shapes, no host read, as ``nms_jax``.
    """
    n = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    b = boxes[order]
    v = valid[order]

    x1 = b[:, 0] - b[:, 2] / 2
    y1 = b[:, 1] - b[:, 3] / 2
    x2 = b[:, 0] + b[:, 2] / 2
    y2 = b[:, 1] + b[:, 3] / 2
    area = b[:, 2] * b[:, 3]

    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = torch.clamp_min(ix2 - ix1, 0.0) * torch.clamp_min(iy2 - iy1, 0.0)
    union = area[:, None] + area[None, :] - inter
    iou = inter / torch.where(union > 0, union, torch.ones_like(union))
    overlaps = iou >= iou_threshold

    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    for i in range(n):
        keep[i] = v[i] & ~(keep[:i] & overlaps[i, :i]).any()
    out = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    out[order] = keep
    return out
