"""Continuous serving CLI: stream a dataset through the
:class:`~async_ev_cnn_torch.utils.serving.StreamingPipeline` engine on the
card.

    python -m async_ev_cnn_torch.scripts.serve -c configs/efcn_event.yml \
        --mode full --num_streams 8 --serve_chunks 64 --out dets.jsonl
    python -m async_ev_cnn_torch.scripts.serve ... --device cpu   # on the CPU

Counterpart of ``async_ev_cnn_tpu/scripts/serve.py`` (its docstring has the
design): the test split becomes ``--num_streams`` endless camera feeds —
examples concatenate onto each stream with timestamps rebased monotone,
network state flows across file boundaries, and every dispatch carries
exactly ``--serve_chunks`` chunks a stream (short tails padded with exact
no-op chunks).  Events cross to the card in the smallest wire tier they
fit (``--serve_wire``, 'auto' by default).  ``--out`` decodes the YOLO head
on the card and writes host-NMS'd detections as JSON lines (a DSL with
``yolo`` layers, such as ``configs/yolov3_tiny_event.yml``, decodes its heads
with ``--yolo_anchors`` and ``--yolo_masks``; one with ``yolox`` layers,
such as RVT's ``configs/rvt_base_event.yml``, with YOLOX's decode at their
strides); ``--serve_state
path.npz`` writes the mid-stream network state at exit and restores it at
start, so a restarted deployment continues its streams' surfaces bit for
bit.  Prints one JSON stats line.

The flags are the JAX CLI's (``utils/config.py``), plus ``--device`` (the
card, ``cuda``, when not given; raises where there is none).  The config's
``network: YoloEventJax`` names the event network, which the port serves as
:class:`~async_ev_cnn_torch.models.yolo.YoloEventTorch`.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from functools import partial

import numpy as np

from async_ev_cnn_torch.data import detection_reader
from async_ev_cnn_torch.models.yolo import YoloEventTorch
from async_ev_cnn_torch.utils.config import build_parser, config, int_groups
from async_ev_cnn_torch.utils.profiling import span
from async_ev_cnn_torch.utils.transforms import data_transform

#: the config names of the event network, all served by YoloEventTorch
EVENT_NETWORKS = ("YoloEventJax", "YoloEventTorch", "YoloEventNumpy")


def _stream_items(reader, args, streams, capacity, t_chunks):
    """Yield ``(stream_slot, raw int64 event array)`` pairs, ``streams``
    consecutive per dispatch round (one per stream slot), until the test
    split is exhausted (ragged tails are flushed as short final items;
    the pipeline pads them to ``t_chunks`` via its pack).  The producer
    worker turns each pair into a :meth:`StreamingPipeline.prepare` item
    — rebase + pack run on the producer thread, overlapping the device
    pipe, while keeping the endless-feed contract (each stream's time
    base rebases once it outlives the int32 µs range, ~35.8 min).
    With ``--keep_polarity`` the 4th (polarity) column rides along."""
    cols = 4 if getattr(args, "keep_polarity", False) else 3
    bufs = [np.zeros((0, cols), np.int64) for _ in range(streams)]
    toffs = [0] * streams  # int64 python ints — unbounded stream time
    pulls, total = 0, reader.test_size()
    need = t_chunks * capacity

    def refill(s):
        nonlocal pulls
        while bufs[s].shape[0] < need and pulls < total:
            _, ev = reader.next_batch(
                1, dataset="test",
                preprocessing_fn=partial(data_transform, args=args),
                concat_features=False, threads=args.reader_threads,
            )
            pulls += 1
            if ev.shape[0] == 0:
                continue
            ev = ev[:, :cols].astype(np.int64)
            ev[:, 2] += toffs[s]
            toffs[s] = int(ev[-1, 2]) + 1
            bufs[s] = np.concatenate([bufs[s], ev])

    while True:
        for s in range(streams):
            refill(s)
        if all(b.shape[0] == 0 for b in bufs):
            return
        for s in range(streams):
            take, bufs[s] = bufs[s][:need], bufs[s][need:]
            yield s, take


def _parser() -> argparse.ArgumentParser:
    """The shared flags and the YOLOv3 heads' own (a DSL's ``yolo``
    layers), which a YAML file may set as well."""
    p = build_parser()
    p.add_argument("--yolo_anchors", type=str, default=None,
                   help="YOLOv3 heads: anchor sizes in input pixels, "
                        "'w,h w,h ...' (darknet's anchors).")
    p.add_argument("--yolo_masks", type=str, default=None,
                   help="YOLOv3 heads: the anchors of each yolo layer, in "
                        "the DSL's order, 'i,j,k i,j,k' (darknet's mask).")
    return p


def _write_detections(fh, res, args, dispatch_idx, streams):
    """Host NMS + JSONL for one retired dispatch's decoded boxes; returns
    the rows written.  Zero-count chunks (``res.counts``) are exact no-op
    padding steps whose outputs repeat the previous surface — skipped, or a
    padded short tail would write duplicate phantom detection rows.  Runs
    in a ``serve.out`` span, the dispatch's."""
    from async_ev_cnn_torch.utils.nms import nms

    with span("serve.out", dispatch_idx):
        boxes, probs = (a.cpu().numpy() for a in res.outputs)
        counts = np.asarray(res.counts)
        # leading axes: [T, ...] or [S, T, ...]
        if streams == 1:
            boxes, probs, counts = boxes[None], probs[None], counts[None]
        n_written = 0
        for s in range(boxes.shape[0]):
            for t in range(boxes.shape[1]):
                if counts[s, t] == 0:
                    continue
                conf = probs[s, t].max(axis=-1)
                cls = probs[s, t].argmax(axis=-1)
                keepable = conf >= args.conf_threshold
                if not keepable.any():
                    continue
                keep = nms(boxes[s, t], conf, valid=keepable, iou_threshold=0.5)
                for k in keep:
                    fh.write(json.dumps({
                        "dispatch": dispatch_idx, "stream": s, "chunk": t,
                        "bbox_xywh": [round(float(v), 2) for v in boxes[s, t, k]],
                        "score": round(float(conf[k]), 4),
                        "class": int(cls[k]),
                    }) + "\n")
                    n_written += 1
        return n_written


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None,
                     help="torch device; the card ('cuda') when not given")
    dev_args, rest = pre.parse_known_args(argv)
    args = config(rest, _parser())

    from async_ev_cnn_torch.models import head
    from async_ev_cnn_torch.ops.conv import set_matmul_precision
    from async_ev_cnn_torch.utils.checkpoint import restore_stream_state, save_stream_state
    from async_ev_cnn_torch.utils.device import resolve_device
    from async_ev_cnn_torch.utils.serving import StreamingPipeline, threaded_source

    device = resolve_device(dev_args.device)
    set_matmul_precision(args.matmul_precision)
    if args.network not in EVENT_NETWORKS:
        raise SystemExit("serve drives the event network (YoloEventJax)")
    keep_polarity = bool(getattr(args, "keep_polarity", False))
    first_cin = next(
        (s[2] for n, s in args.yolo_cnn_layers.items() if "conv" in n), 1)
    if keep_polarity and first_cin != 2:
        raise SystemExit(
            "--keep_polarity serves a 2-channel (ON/OFF) surface network: "
            f"the first conv's in_channels must be 2, got {first_cin} "
            "(adjust the config's conv1)"
        )

    reader = detection_reader.factory(args.input_data_dir,
                                      file_format=args.file_format)
    model = YoloEventTorch(
        h_frame=args.frame_h, w_frame=args.frame_w,
        num_classes=reader.num_classes(), cnn_layers=args.yolo_cnn_layers,
        cnn_padding=args.yolo_cnn_padding, h_cells=args.yolo_num_cells_h,
        w_cells=args.yolo_num_cells_w, num_bbox=args.yolo_num_bbox,
        alpha=0.1, leak=args.leak, checkpoint=args.restore_net,
        conv_mode=args.mode, stem_fusion=args.stem_fusion,
        activation_dtype=args.activation_dtype, device=device,
    )
    if not model.net.is_all_full:
        raise SystemExit(
            "serve requires conv_mode 'full'/'auto' for every layer "
            "(the parallel-in-time dispatch; incremental per-chunk modes "
            "cannot be time-batched)"
        )

    capacity = max(int(args.batch_event_size), 1)
    streams = max(int(args.num_streams), 1)
    t_chunks = int(args.serve_chunks)
    num_classes = reader.num_classes()

    post = None
    if args.out and model.net.head_strides:
        strides = model.net.head_strides

        def post(outs):  # the YOLOX levels, decoded together
            boxes, _, probs = head.decode_yolox(outs, strides)
            return boxes, probs
    elif args.out and model.net.heads:
        if not (args.yolo_anchors and args.yolo_masks):
            raise SystemExit("--out with yolo layers decodes with --yolo_anchors "
                             "and --yolo_masks")
        anchors, masks = int_groups(args.yolo_anchors), int_groups(args.yolo_masks)

        def post(outs):  # the YOLOv3 heads, decoded together
            boxes, _, probs = head.decode_yolov3(outs, anchors, masks,
                                                 args.frame_h, args.frame_w)
            return boxes, probs
    elif args.out:
        def post(outs):
            # only boxes and class probs cross back to the host: the
            # decoded probs already carry the box confidence
            boxes, _, probs = head.decode(outs, num_classes, args.yolo_num_bbox,
                                          args.frame_h, args.frame_w)
            return boxes, probs

    pipe = StreamingPipeline(model.net, model.params, capacity=capacity,
                             streams=streams, postprocess=post,
                             wire=args.serve_wire, t_chunks=t_chunks,
                             keep_polarity=keep_polarity, device=device)
    state_restored = False
    if args.serve_state and os.path.exists(args.serve_state):
        pipe.state = restore_stream_state(args.serve_state, pipe.state)
        state_restored = True
    # rebase + pack run inside the (single) producer worker via prepare(),
    # overlapping the device pipe; threads=1 keeps prepare()'s in-order
    # contract
    src = threaded_source(
        lambda: _stream_items(reader, args, streams, capacity, t_chunks),
        fn=lambda st: pipe.prepare(st[1], stream=st[0]),
        depth=max(4, streams + 2), threads=1,
    )

    # a resumed run APPENDS: truncating would destroy the detections
    # written before the stop that the state checkpoint continues from
    fh = (open(args.out, "a" if state_restored else "w")
          if args.out else None)
    n_events = n_dispatches = n_det = 0
    t0 = time.time()
    try:
        for res in pipe.serve(src):
            n_events += res.n_events
            if fh is not None:
                n_det += _write_detections(fh, res, args, n_dispatches, streams)
            n_dispatches += 1
            if (args.serve_max_dispatches is not None
                    and n_dispatches >= args.serve_max_dispatches):
                break
    finally:
        if fh is not None:
            fh.close()
        if args.serve_state:
            save_stream_state(args.serve_state, pipe.state)
    dt = time.time() - t0

    stats = {
        "device": str(device),
        "dispatches": n_dispatches,
        "streams": streams,
        "chunks_per_dispatch": t_chunks,
        "events": n_events,
        "seconds": round(dt, 3),
        "events_per_sec": round(n_events / max(dt, 1e-9), 1),
        "detections_written": n_det if fh is not None else None,
        "state_restored": state_restored,
        "wire_tier": pipe.wire_tier,
        "wire_bytes": pipe.stats["wire_bytes"],
        "wire_MBps": round(pipe.stats["wire_bytes"] / max(dt, 1e-9) / 2**20, 2),
        # the negotiated tier as bytes/event (~2.5 ultra4 / 3 ultra / 4
        # compact / 8 plain, + chunk overhead)
        "wire_B_per_event": round(
            pipe.stats["wire_bytes"] / max(pipe.stats["events"], 1), 2),
        "latency": pipe.latency_stats(),
        "rebased_epochs_us": [e for e in pipe._epochs if e] or None,
    }
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
