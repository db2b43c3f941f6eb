"""Detection evaluation CLI: mAP of a network over the test split.

    python -m async_ev_cnn_torch.scripts.evaluate -c configs/efcn_event.yml
    python -m async_ev_cnn_torch.scripts.evaluate ... --device cpu   # on the CPU

Counterpart of ``async_ev_cnn_tpu/scripts/evaluate.py``, with its flags
(``--eval_iou`` besides the config's) plus ``--device`` (the card,
``cuda``, when not given; raises where there is none).  Streams every test
example through the selected network (the event model stepped over
micro-batches, or a dense frame model on the final integrated frame),
decodes and NMS's the final grid, and scores PASCAL-VOC mAP against the
dataset annotations, printing the JAX CLI's JSON line.  Annotation
convention (detection_reader): ``[N, 6]`` rows ``(x, y, w, h, class, _)``
normalized to the example frame.
"""

from __future__ import annotations

import argparse
import json
from functools import partial

import numpy as np

from async_ev_cnn_torch.data import detection_reader
from async_ev_cnn_torch.utils.config import config
from async_ev_cnn_torch.utils.transforms import center_crop


def _eval_transform(l, x, y, ts, p, bboxes, args):
    """Like the runner's data_transform but keeps the (cropped) bboxes."""
    ts = ts - ts[0] if len(ts) else ts
    if args.frame_h != args.example_h or args.frame_w != args.example_w:
        l, x, y, ts, p, bboxes = center_crop(
            l, x, y, ts, p, bboxes,
            (args.example_h, args.example_w), (args.frame_h, args.frame_w),
        )
    events = np.stack([y, x, ts], axis=-1)
    bboxes = np.asarray(bboxes, np.float32)
    if len(bboxes):
        # center_crop zeroes w/h of boxes whose center leaves the crop
        # window; a zero-area ground truth can never be matched (IoU 0)
        # and would permanently deflate recall/mAP — drop it here, like
        # scripts/train.build_targets drops w/h <= 0 rows
        bboxes = bboxes[(bboxes[:, 2] > 0) & (bboxes[:, 3] > 0)]
    return l, events, bboxes


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--eval_iou", type=float, default=0.5)
    pre.add_argument("--device", default=None,
                     help="torch device; the card ('cuda') when not given")
    pre_args, argv_rest = pre.parse_known_args(argv)
    args = config(argv_rest)
    from async_ev_cnn_torch.models.yolo import YoloEventTorch, YoloFrameNumpy
    from async_ev_cnn_torch.ops.conv import set_matmul_precision
    from async_ev_cnn_torch.ops.integrate import integrate_frame_chunked
    from async_ev_cnn_torch.scripts.run_networks import _NETWORKS
    from async_ev_cnn_torch.utils.device import resolve_device
    from async_ev_cnn_torch.utils.evaluation import decode_predictions, evaluate_detections
    from async_ev_cnn_torch.utils.runner import split_micro_batches

    device = resolve_device(pre_args.device)
    set_matmul_precision(args.matmul_precision)
    if args.yolo_cnn_layers is None:
        raise SystemExit(
            "no network layers configured: pass -c <config.yml> or "
            "--yolo_cnn_layers"
        )
    if getattr(args, "keep_polarity", False):
        # _eval_transform stacks [y, x, ts] only; silently dropping p
        # would integrate every event into channel 0 of a 2-channel net
        raise SystemExit(
            "evaluate does not support keep_polarity (polarity-surface "
            "evaluation needs run_networks)"
        )
    reader = detection_reader.factory(args.input_data_dir, file_format=args.file_format)
    network_class = _NETWORKS[args.network]
    is_event = network_class is YoloEventTorch
    network = network_class(
        h_frame=args.frame_h, w_frame=args.frame_w,
        num_classes=reader.num_classes(), cnn_layers=args.yolo_cnn_layers,
        cnn_padding=args.yolo_cnn_padding, h_cells=args.yolo_num_cells_h,
        w_cells=args.yolo_num_cells_w, num_bbox=args.yolo_num_bbox,
        alpha=0.1, leak=args.leak, checkpoint=args.restore_net,
        **({"conv_mode": args.mode} if is_event else {}),
        **({} if network_class is YoloFrameNumpy else {"device": device}),
    )
    graph = network.build_graph(None)

    predictions, ground_truths = [], []
    for _ in range(reader.test_size()):
        _, events, bboxes = reader.next_batch(
            1, dataset="test",
            preprocessing_fn=partial(_eval_transform, args=args),
            threads=args.reader_threads,
        )
        frame_state = None
        reset = True
        out = None
        for batch in split_micro_batches(events, args.batch_event_size,
                                         args.batch_event_usec):
            if is_event:
                out = graph(batch, reset)
                reset = False
            else:
                frame, prev_ts = integrate_frame_chunked(
                    batch, args.leak, args.frame_h, args.frame_w,
                    frame_state, slice_len=max(256, args.batch_event_size),
                    device=device,
                )
                frame_state = [frame, prev_ts]
        gt_boxes = bboxes[:, :4] * np.array(
            [args.frame_w, args.frame_h, args.frame_w, args.frame_h], np.float32)
        ground_truths.append((gt_boxes, bboxes[:, 4].astype(np.int64)))
        if out is None and frame_state is None:
            # a fully-cropped-out example has zero micro-batches: score
            # an empty prediction set (its ground truth counts as missed)
            predictions.append((np.zeros((0, 4), np.float32),
                                np.zeros(0, np.float32),
                                np.zeros(0, np.int64)))
            continue
        if not is_event:
            out = graph(frame_state[0])
        predictions.append(decode_predictions(
            out, reader.num_classes(), args.yolo_num_bbox, args.frame_h, args.frame_w,
        ))

    result = evaluate_detections(
        predictions, ground_truths, reader.num_classes(),
        iou_threshold=pre_args.eval_iou,
    )
    print(json.dumps({
        f"mAP@{pre_args.eval_iou}": round(result["mAP"], 4),
        "examples": len(predictions),
        "ap_per_class": [None if np.isnan(a) else round(a, 4)
                         for a in result["ap_per_class"]],
    }))
    return result


if __name__ == "__main__":
    main()
