"""Prediction visualisation: YOLO decode + NMS + box drawing.

Copied from ``async_ev_cnn_tpu/utils/viz.py`` (host numpy; decoding by the
port's ``models/head.decode``; held against the original by
tests/test_torch_postprocess.py).

Capability parity with reference src/libs/viz.py:125-176
(``draw_bboxes``: confidence = class-prob x box-conf, threshold, optional
NMS, label lookup, confidence-scaled styling).  OpenCV is optional — when
absent, a minimal numpy rasteriser draws 1-px rectangles so headless
environments still get images.
"""

from __future__ import annotations

import numpy as np

from async_ev_cnn_torch.models.head import decode
from async_ev_cnn_torch.utils.nms import apply_nms

try:  # pragma: no cover - environment-dependent
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def _normalize(img):
    lo, hi = float(img.min()), float(img.max())
    return (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)


def _draw_rect_np(img, x1, y1, x2, y2, color, alpha):
    h, w = img.shape[:2]
    x1, x2 = np.clip([x1, x2], 0, w - 1).astype(int)
    y1, y2 = np.clip([y1, y2], 0, h - 1).astype(int)
    for (ys, xs) in [
        (slice(y1, y1 + 1), slice(x1, x2 + 1)),
        (slice(y2, y2 + 1), slice(x1, x2 + 1)),
        (slice(y1, y2 + 1), slice(x1, x1 + 1)),
        (slice(y1, y2 + 1), slice(x2, x2 + 1)),
    ]:
        img[ys, xs] = (1 - alpha) * img[ys, xs] + alpha * color
    return img


def draw_bboxes(
    net_predictions,
    frame,
    h_grid: int,
    w_grid: int,
    num_classes: int,
    idx_to_label=None,
    conf_threshold: float = 0.2,
    use_nms: bool = False,
    nms_threshold: float = 0.2,
    max_thickness: int = 5,
    highlight_top_n: int = 0,
    resize_ratio: int = 1,
):
    """Render predictions onto the integrated frame.

    ``net_predictions``: ``[h_grid, w_grid, C + B*5]``; ``frame``: ``[H, W]``.
    Returns a float32 RGB image batch ``[1, H*r, W*r, 3]``.
    """
    frame = np.asarray(frame, np.float32)
    h_image, w_image = frame.shape
    # decode() infers the grid from the prediction shape; the explicit
    # grid args exist for reference-signature parity — validate them so
    # a transposed/misconfigured grid fails here, not as garbage boxes
    if tuple(net_predictions.shape[:2]) != (h_grid, w_grid):
        raise ValueError(
            f"prediction grid {net_predictions.shape[:2]} != configured "
            f"({h_grid}, {w_grid})"
        )
    num_bbox = (net_predictions.shape[-1] - num_classes) // 5

    boxes, scores, probs = decode(
        np.asarray(net_predictions), num_classes, num_bbox, h_image, w_image
    )
    boxes, scores, probs = boxes.numpy(), scores.numpy(), probs.numpy()
    valid = scores > conf_threshold

    if use_nms and valid.any():
        _, picked = apply_nms(boxes[None], scores[None], valid[None], nms_threshold)
        mask = np.zeros_like(valid)
        mask[picked] = True
        valid = valid & mask

    if idx_to_label is None:
        idx_to_label = np.array([str(i) for i in range(num_classes)])
    labels = np.asarray(idx_to_label)[np.argmax(probs, axis=-1)]

    img = _normalize(frame)[..., None].repeat(3, axis=-1)

    order = np.argsort(-scores)
    order = order[valid[order]]
    for rank, i in enumerate(order):
        x, y, w, h = boxes[i]
        conf = float(np.clip(scores[i], 0, 1))
        color = np.array([0.0, 0.0, 1.0]) if rank < highlight_top_n else np.array([1.0, 1.0, 1.0])
        alpha = 0.2 + 0.8 * conf
        x1, y1, x2, y2 = x - w / 2, y - h / 2, x + w / 2, y + h / 2
        if cv2 is not None:
            thick = max(1, int(conf * max_thickness))
            # OpenCV >= 5 draws text only on uint8 images
            overlay = np.zeros(img.shape[:2] + (3,), np.uint8)
            col255 = tuple(int(c * 255) for c in color)
            cv2.rectangle(overlay, (int(x1) - 1, int(y1) - 1), (int(x2) + 1, int(y2) + 1),
                          col255, thick)
            txt = f"{labels[i]} {int(conf * 100)}%" if rank < highlight_top_n else str(labels[i])
            cv2.putText(overlay, txt, (int(x1) - 1, int(y1) - 3),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.35, col255)
            img = np.clip(img + alpha * overlay.astype(np.float32) / 255.0, 0, 1)
        else:
            img = _draw_rect_np(img, x1, y1, x2, y2, color, alpha)

    if resize_ratio != 1:
        if cv2 is not None:
            img = cv2.resize(img, (w_image * resize_ratio, h_image * resize_ratio),
                             interpolation=cv2.INTER_NEAREST)
        else:
            img = img.repeat(resize_ratio, axis=0).repeat(resize_ratio, axis=1)

    return img[None].astype(np.float32)


def show_frame(image, delay_ms: int = 50, window: str = "Predictions"):  # pragma: no cover
    """Display one drawn frame (no-op without OpenCV/GUI)."""
    if cv2 is None:
        return
    cv2.imshow(window, image)
    cv2.waitKey(delay_ms)
