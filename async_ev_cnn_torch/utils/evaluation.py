"""Detection evaluation: IoU matching, per-class average precision, mAP.

Copied from ``async_ev_cnn_tpu/utils/evaluation.py`` (host numpy; held
against the original by tests/test_torch_postprocess.py).  Only
:func:`decode_predictions` touches the port: it decodes with the port's
``models/head.decode`` on the grid's device and evaluates on the host.

The reference ships no evaluation harness (its numbers live only in the
companion paper); this provides the standard PASCAL-VOC-style protocol:
greedy IoU matching of score-ranked predictions against ground truth, AP by
all-point interpolation, mAP over classes.

Boxes are center-format ``(x, y, w, h)`` everywhere (the framework's native
convention, models/head.decode).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def iou_matrix(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of center-format boxes ``[N, 4]`` x ``[M, 4]``."""
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)), np.float32)
    ax1 = boxes_a[:, 0] - boxes_a[:, 2] / 2
    ay1 = boxes_a[:, 1] - boxes_a[:, 3] / 2
    ax2 = boxes_a[:, 0] + boxes_a[:, 2] / 2
    ay2 = boxes_a[:, 1] + boxes_a[:, 3] / 2
    bx1 = boxes_b[:, 0] - boxes_b[:, 2] / 2
    by1 = boxes_b[:, 1] - boxes_b[:, 3] / 2
    bx2 = boxes_b[:, 0] + boxes_b[:, 2] / 2
    by2 = boxes_b[:, 1] + boxes_b[:, 3] / 2
    ix1 = np.maximum(ax1[:, None], bx1[None, :])
    iy1 = np.maximum(ay1[:, None], by1[None, :])
    ix2 = np.minimum(ax2[:, None], bx2[None, :])
    iy2 = np.minimum(ay2[:, None], by2[None, :])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area_a = boxes_a[:, 2] * boxes_a[:, 3]
    area_b = boxes_b[:, 2] * boxes_b[:, 3]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.where(union > 0, union, 1)


def average_precision(recalls: np.ndarray, precisions: np.ndarray) -> float:
    """All-point interpolated AP (area under the monotone PR envelope)."""
    r = np.concatenate([[0.0], recalls, [1.0]])
    p = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(len(p) - 2, -1, -1):
        p[i] = max(p[i], p[i + 1])
    idx = np.where(r[1:] != r[:-1])[0]
    return float(np.sum((r[idx + 1] - r[idx]) * p[idx + 1]))


def evaluate_detections(
    predictions: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    ground_truths: Sequence[Tuple[np.ndarray, np.ndarray]],
    num_classes: int,
    iou_threshold: float = 0.5,
) -> Dict:
    """PASCAL-VOC mAP.

    Args:
      predictions: per image, ``(boxes [N, 4], scores [N], classes [N])``.
      ground_truths: per image, ``(boxes [M, 4], classes [M])``.
      num_classes: class count.
      iou_threshold: match threshold.

    Returns:
      ``{"mAP": float, "ap_per_class": [float] * num_classes,
         "num_gt_per_class": [...]}`` (classes with no ground truth get
      NaN AP and are excluded from the mean).
    """
    if len(predictions) != len(ground_truths):
        # zip would silently truncate and score a different example set
        # than the caller thinks
        raise ValueError(
            f"{len(predictions)} prediction lists vs "
            f"{len(ground_truths)} ground-truth lists"
        )
    ap_per_class: List[float] = []
    gt_counts: List[int] = []
    for cls in range(num_classes):
        records = []  # (score, is_tp)
        n_gt = 0
        for (p_boxes, p_scores, p_classes), (g_boxes, g_classes) in zip(
            predictions, ground_truths
        ):
            g_sel = np.asarray(g_classes) == cls
            g = np.asarray(g_boxes, np.float32)[g_sel]
            n_gt += len(g)
            p_sel = np.asarray(p_classes) == cls
            p = np.asarray(p_boxes, np.float32)[p_sel]
            s = np.asarray(p_scores, np.float32)[p_sel]
            order = np.argsort(-s)
            matched = np.zeros(len(g), bool)
            ious = iou_matrix(p[order], g)
            for rank, pi in enumerate(order):
                if len(g) == 0:
                    records.append((s[pi], False))
                    continue
                j = int(np.argmax(ious[rank]))
                if ious[rank, j] >= iou_threshold and not matched[j]:
                    matched[j] = True
                    records.append((s[pi], True))
                else:
                    records.append((s[pi], False))
        gt_counts.append(n_gt)
        if n_gt == 0:
            ap_per_class.append(float("nan"))
            continue
        if not records:
            ap_per_class.append(0.0)
            continue
        records.sort(key=lambda r: -r[0])
        tp = np.cumsum([r[1] for r in records])
        fp = np.cumsum([not r[1] for r in records])
        recalls = tp / n_gt
        precisions = tp / np.maximum(tp + fp, 1)
        ap_per_class.append(average_precision(recalls, precisions))

    valid = [a for a in ap_per_class if not np.isnan(a)]
    return {
        "mAP": float(np.mean(valid)) if valid else 0.0,
        "ap_per_class": ap_per_class,
        "num_gt_per_class": gt_counts,
    }


def decode_predictions(
    grid_out: np.ndarray,
    num_classes: int,
    num_bbox: int,
    h_image: int,
    w_image: int,
    conf_threshold: float = 0.1,
    use_nms: bool = True,
    nms_threshold: float = 0.5,
):
    """Grid output -> ``(boxes, scores, classes)`` ready for evaluation.

    Standard YOLO/VOC protocol: the detection score for class ``c`` is
    the class probability scaled by box confidence (``decode``'s
    ``probs`` column — NOT the raw objectness, which is class-agnostic
    and mis-ranks every per-class PR curve), thresholding and NMS run
    PER CLASS (class-agnostic NMS suppresses genuinely overlapping
    objects of different classes), and one box may emit detections for
    several classes."""
    from async_ev_cnn_torch.models.head import decode
    from async_ev_cnn_torch.utils.nms import nms

    boxes, _, probs = decode(grid_out, num_classes, num_bbox, h_image, w_image)
    boxes, probs = boxes.cpu().numpy(), probs.cpu().numpy()
    out_boxes, out_scores, out_classes = [], [], []
    for cls in range(num_classes):
        s = probs[:, cls]
        keep = s > conf_threshold
        b, sc = boxes[keep], s[keep]
        if use_nms and len(b):
            picked = nms(b, sc, iou_threshold=nms_threshold)
            b, sc = b[picked], sc[picked]
        out_boxes.append(b)
        out_scores.append(sc)
        out_classes.append(np.full(len(b), cls, np.int64))
    if not out_boxes:
        return (np.zeros((0, 4), np.float32), np.zeros(0, np.float32),
                np.zeros(0, np.int64))
    return (np.concatenate(out_boxes), np.concatenate(out_scores),
            np.concatenate(out_classes))
