"""The port's detection post-processing held against the JAX package: NMS
on the host and on the device (async_ev_cnn_torch/utils/nms.py), the
evaluation protocol (utils/evaluation.py), the event transforms
(utils/transforms.py) and the box drawing (utils/viz.py).

Tolerance: none.  The host modules are copies, so every output is compared
equal (index arrays, keep masks, the mAP dict, cropped events, drawn
images); the device NMS keeps exactly the boxes ``nms_jax`` keeps.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from async_ev_cnn_torch.utils import evaluation as teval
from async_ev_cnn_torch.utils import nms as tnms
from async_ev_cnn_torch.utils import transforms as ttf
from async_ev_cnn_torch.utils import viz as tviz
from async_ev_cnn_tpu.utils import evaluation as jeval
from async_ev_cnn_tpu.utils.nms import apply_nms as j_apply_nms
from async_ev_cnn_tpu.utils.nms import nms as j_nms
from async_ev_cnn_tpu.utils.nms import nms_jax as j_nms_jax
from async_ev_cnn_tpu.utils import transforms as jtf
from async_ev_cnn_tpu.utils import viz as jviz

torch.set_num_threads(2)


def _boxes(rng, n, ties=True):
    """Center-format boxes in clusters (so NMS suppresses), with repeated
    boxes and tied scores."""
    centres = rng.rand(max(1, n // 4), 2) * 80 + 10
    xy = centres[rng.randint(0, len(centres), n)] + rng.randn(n, 2) * 3
    wh = rng.rand(n, 2) * 20 + 5
    boxes = np.concatenate([xy, wh], 1).astype(np.float32)
    scores = rng.rand(n).astype(np.float32)
    if ties:
        boxes[1::5] = boxes[0::5][: len(boxes[1::5])]
        scores[1::5] = scores[0::5][: len(scores[1::5])]
        scores[2::7] = 0.5
    return boxes, scores


@pytest.mark.parametrize("n", [1, 7, 40])
@pytest.mark.parametrize("threshold", [0.2, 0.5])
def test_nms_matches_jax(rng, n, threshold):
    """Host NMS: the same picks in the same order, with a bool and a 0/1
    int validity mask; batched apply_nms the same index pairs."""
    boxes, scores = _boxes(rng, n)
    valid = rng.rand(n) < 0.8
    for v in (None, valid, valid.astype(np.int64)):
        got = tnms.nms(boxes, scores, v, threshold)
        want = j_nms(boxes, scores, v, threshold)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    batch = np.stack([boxes, boxes[::-1]])
    bs = np.stack([scores, scores[::-1]])
    bv = np.stack([valid, valid[::-1]])
    for args in ((batch, bs), (batch, bs, bv)):
        for g, w in zip(tnms.apply_nms(*args, iou_threshold=threshold),
                        j_apply_nms(*args, iou_threshold=threshold)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [1, 7, 40])
@pytest.mark.parametrize("threshold", [0.2, 0.5])
def test_nms_torch_matches_nms_jax_on_ties(rng, n, threshold):
    """The device NMS keeps the boxes nms_jax keeps, tied scores and
    identical boxes included (a stable descending sort in both), and the
    same set as the host nms."""
    boxes, scores = _boxes(rng, n)
    valid = rng.rand(n) < 0.8
    got = tnms.nms_torch(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(valid), threshold)
    want = np.asarray(j_nms_jax(jnp.asarray(boxes), jnp.asarray(scores),
                                   jnp.asarray(valid), threshold))
    assert got.dtype == torch.bool and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.where(got.numpy())[0],
                                  np.sort(tnms.nms(boxes, scores, valid, threshold)))


def test_nms_tied_identical_boxes():
    """tests/test_evaluation.py's tie case: both paths keep box 0."""
    tb = np.array([[10, 10, 4, 4], [10, 10, 4, 4], [40, 40, 4, 4]], np.float32)
    tsc = np.array([0.9, 0.9, 0.5], np.float32)
    keep = tnms.nms_torch(torch.from_numpy(tb), torch.from_numpy(tsc), torch.ones(3, dtype=bool))
    np.testing.assert_array_equal(keep.numpy(), [True, False, True])
    np.testing.assert_array_equal(tnms.nms(tb, tsc), j_nms(tb, tsc))


def _grid(rng, num_classes=3, num_bbox=2, sh=4, sw=5):
    grid = rng.rand(sh, sw, num_classes + num_bbox * 5).astype(np.float32)
    grid[..., num_classes + 4::5] **= 3  # a few confident boxes
    return grid


def test_evaluation_matches_jax(rng):
    """iou_matrix, average_precision, evaluate_detections and
    decode_predictions: the same numbers."""
    a, _ = _boxes(rng, 9)
    b, _ = _boxes(rng, 6)
    np.testing.assert_array_equal(teval.iou_matrix(a, b), jeval.iou_matrix(a, b))
    assert teval.iou_matrix(a[:0], b).shape == (0, 6)
    r = np.sort(rng.rand(12))
    p = rng.rand(12)
    assert teval.average_precision(r, p) == jeval.average_precision(r, p)

    preds, gts = [], []
    for _ in range(4):
        grid = _grid(rng)
        for kw in ({}, {"use_nms": False, "conf_threshold": 0.3}):
            g = teval.decode_predictions(grid, 3, 2, 64, 80, **kw)
            w = jeval.decode_predictions(grid, 3, 2, 64, 80, **kw)
            for x, y in zip(g, w):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
        preds.append(g)
        gb, _ = _boxes(rng, 3, ties=False)
        gts.append((gb, rng.randint(0, 4, 3)))
    got = teval.evaluate_detections(preds, gts, num_classes=4, iou_threshold=0.3)
    want = jeval.evaluate_detections(preds, gts, num_classes=4, iou_threshold=0.3)
    np.testing.assert_equal(got, want)
    with pytest.raises(ValueError, match="prediction lists"):
        teval.evaluate_detections(preds, gts[:-1], num_classes=4)


def test_decode_predictions_from_a_tensor(rng):
    """A grid tensor (the frame models' output) decodes as its array."""
    grid = _grid(rng)
    for x, y in zip(teval.decode_predictions(torch.from_numpy(grid), 3, 2, 64, 80),
                    jeval.decode_predictions(grid, 3, 2, 64, 80)):
        np.testing.assert_array_equal(x, y)


def test_transforms_match_jax(rng):
    n = 400
    x = rng.randint(0, 40, n).astype(np.int32)
    y = rng.randint(0, 30, n).astype(np.int32)
    ts = np.sort(rng.randint(100, 1000, n)).astype(np.int32)
    p = rng.randint(0, 2, n).astype(np.int32)
    bboxes = np.array([[0.5, 0.5, 0.2, 0.2, 1, 0], [0.05, 0.9, 0.1, 0.3, 2, 0]], np.float32)
    for shape in ((10, 12), (30, 40), (1, 1)):
        got = ttf.center_crop(n, x, y, ts, p, bboxes, (30, 40), shape)
        want = jtf.center_crop(n, x, y, ts, p, bboxes, (30, 40), shape)
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)
    for keep in (False, True):
        args = SimpleNamespace(frame_h=10, frame_w=12, example_h=30, example_w=40,
                               keep_polarity=keep)
        got = ttf.data_transform(n, x, y, ts, p, bboxes, args)
        want = jtf.data_transform(n, x, y, ts, p, bboxes, args)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError, match="int32"):
        ttf.data_transform(2, x[:2], y[:2], np.array([0, 2**32]), p[:2], bboxes, args)


@pytest.mark.parametrize("kw", [
    {},
    {"use_nms": True, "highlight_top_n": 2, "nms_threshold": 0.3},
    {"resize_ratio": 3, "conf_threshold": 0.05},
    {"conf_threshold": 2.0},
])
def test_viz_matches_jax(rng, kw):
    frame = rng.rand(32, 40).astype(np.float32)
    grid = _grid(rng)
    got = tviz.draw_bboxes(grid, frame, 4, 5, 3, **kw)
    want = jviz.draw_bboxes(grid, frame, 4, 5, 3, **kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="prediction grid"):
        tviz.draw_bboxes(grid, frame, 5, 4, 3)
