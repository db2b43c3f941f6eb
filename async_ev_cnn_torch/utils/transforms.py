"""Event-stream preprocessing transforms.

Copied from ``async_ev_cnn_tpu/utils/transforms.py`` (host numpy; held
against the original by tests/test_torch_postprocess.py).

``center_crop`` is the reference's events+bboxes crop
(reference src/libs/utils.py:4-35) with its two bugs fixed and
documented:

* the reference computes the crop window top from the **x** extent and left
  from the **y** extent (axes swapped, utils.py:17-18) — here the window is
  computed per-axis correctly;
* the reference scales bboxes by ``old_w/old_h`` twice (utils.py:28-32) and
  shifts both axes by ``new_x.min()`` (utils.py:33) — here boxes are scaled
  once and shifted by the matching axis.

``data_transform`` mirrors runner.py:24-33: rebase timestamps, center-crop
to the network resolution, stack events as ``[y, x, ts]`` (polarity dropped,
like the reference).
"""

from __future__ import annotations

import numpy as np


def center_crop(l, x, y, ts, p, bboxes, old_shape, new_shape):
    """Crop events (and normalized xywh bboxes) to a centered window.

    Events are shifted so the cropped extent starts at (0, 0); bboxes are
    renormalized to the new window.  Returns
    ``(length, x, y, ts, p, bboxes)``.
    """
    new_h, new_w = new_shape

    x_min, x_max = int(x.min()), int(x.max())
    y_min, y_max = int(y.min()), int(y.max())

    left = x_min + (x_max - x_min - new_w) // 2
    top = y_min + (y_max - y_min - new_h) // 2

    inside = (x >= left) & (x < left + new_w) & (y >= top) & (y < top + new_h)
    new_x, new_y, new_ts, new_p = x[inside], y[inside], ts[inside], p[inside]
    if new_x.size == 0:
        return 0, new_x, new_y, new_ts, new_p, np.zeros_like(bboxes)
    shift_x = int(new_x.min())
    shift_y = int(new_y.min())
    new_x = new_x - shift_x
    new_y = new_y - shift_y

    if bboxes is not None and len(bboxes):
        old_h, old_w = old_shape
        bb = np.array(bboxes, np.float32, copy=True)
        # xywh: only the CENTER columns shift with the crop window; the
        # width/height columns just rescale (shifting them shrank every
        # box by the crop offset and zeroed narrow ones)
        cx = bb[:, 0] * old_w - shift_x
        cy = bb[:, 1] * old_h - shift_y
        # an object whose CENTER fell outside the window is cropped out:
        # zero its w/h (downstream target builders drop w/h <= 0 rows)
        # instead of clamping the center to the edge, which manufactured
        # spurious full-size edge ground-truth boxes
        outside = (cx < 0) | (cx >= new_w) | (cy < 0) | (cy >= new_h)
        bb[:, 0] = np.clip(cx, 0, new_w) / new_w
        bb[:, 1] = np.clip(cy, 0, new_h) / new_h
        bb[:, 2] = np.where(outside, 0.0, np.clip(bb[:, 2] * old_w, 0, new_w) / new_w)
        bb[:, 3] = np.where(outside, 0.0, np.clip(bb[:, 3] * old_h, 0, new_h) / new_h)
    else:
        bb = bboxes

    return int(new_x.shape[0]), new_x, new_y, new_ts, new_p, bb


def data_transform(l, x, y, ts, p, bboxes, args):
    """Reference runner preprocessing (runner.py:24-33): rebase ts,
    center-crop to (frame_h, frame_w), stack ``[y, x, ts]``.

    With ``args.keep_polarity`` the polarity column is appended
    (``[y, x, ts, p]``) for 2-channel ON/OFF surfaces — the reference always
    drops it (runner.py:32)."""
    ts = ts - ts[0] if len(ts) else ts
    if len(ts) and int(np.asarray(ts).max()) > np.iinfo(np.int32).max:
        raise ValueError(
            "event stream spans more than int32 µs (~35.8 min) even after "
            "rebasing; split the recording before feeding the network"
        )
    if args.frame_h != args.example_h or args.frame_w != args.example_w:
        l, x, y, ts, p, bboxes = center_crop(
            l, x, y, ts, p, bboxes,
            (args.example_h, args.example_w),
            (args.frame_h, args.frame_w),
        )
    cols = [y, x, ts] + ([p] if getattr(args, "keep_polarity", False) else [])
    events = np.stack(cols, axis=-1)
    return l, events
