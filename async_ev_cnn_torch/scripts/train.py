"""Training CLI: fit the eFCN on a detection dataset's integrated frames.

    python -m async_ev_cnn_torch.scripts.train -c configs/efcn_event.yml \\
        --train_steps 500 --save_to data/checkpoints/my.npz
    python -m async_ev_cnn_torch.scripts.train ... --device cpu   # on the CPU

Counterpart of ``async_ev_cnn_tpu/scripts/train.py``, with its flags plus
``--device`` (the card, ``cuda``, when not given; raises where there is
none).  Per step: sample ``batch_size`` training examples, integrate each
full event stream into a frame on the device, build YOLO grid targets from
the annotations (``(x, y, w, h, class, _)`` normalized), and take one Adam
step (``models/train.Trainer``).  The checkpoint (``w_<name>``/``b_<name>``,
HWIO) loads into any network of either package, and the sibling
``<ckpt>.opt.npz`` holds the optimizer state in the JAX CLI's layout, so a
run resumes in either package.  The seeded initialisation is the JAX
CLI's bit for bit.
"""

from __future__ import annotations

import argparse
import json
import os
from functools import partial

import numpy as np

from async_ev_cnn_torch.data import detection_reader
from async_ev_cnn_torch.scripts.evaluate import _eval_transform
from async_ev_cnn_torch.utils.config import build_parser


def opt_state_path(ckpt_path: str) -> str:
    """Sibling file holding the optimizer state for a weights checkpoint."""
    base = ckpt_path[:-4] if ckpt_path.endswith(".npz") else ckpt_path
    return base + ".opt.npz"


def build_targets(bboxes: np.ndarray, sh: int, sw: int):
    """Annotations ``[N, 6]`` (normalized xywh + class) -> grid targets.

    Degenerate rows (w or h <= 0) are skipped: ``center_crop`` zero-fills
    when a crop removes everything, and the reader's ragged batch padding
    is all-zero rows — neither is an object, and a spurious obj=1 at grid
    cell (0, 0) would bias every run on cropped/batched data."""
    boxes = np.zeros((sh, sw, 4), np.float32)
    obj = np.zeros((sh, sw), np.float32)
    cls = np.zeros((sh, sw), np.int32)
    for row in np.asarray(bboxes, np.float32):
        x, y, w, h, c = row[:5]
        if w <= 0 or h <= 0:
            continue
        cell_x = min(int(x * sw), sw - 1)
        cell_y = min(int(y * sh), sh - 1)
        boxes[cell_y, cell_x] = [x * sw - cell_x, y * sh - cell_y, w, h]
        obj[cell_y, cell_x] = 1.0
        cls[cell_y, cell_x] = int(c)
    return boxes, obj, cls


def init_params(layers) -> dict:
    """He-normal conv and fc weights from ``RandomState(0)`` in the layer
    order, zero biases, in the checkpoint layout: the JAX CLI's
    initialisation bit for bit (its float64 products rounded to float32
    once, as ``jnp.asarray`` rounds them)."""
    rng = np.random.RandomState(0)
    params = {}
    for name, size in layers.items():
        if "conv" in name:
            kh, kw, ci, co = size
            scale = np.sqrt(2.0 / (kh * kw * ci))
            params[f"w_{name}"] = (
                rng.randn(kh, kw, ci, co).astype(np.float32) * scale).astype(np.float32)
            params[f"b_{name}"] = np.zeros(co, np.float32)
        elif "fc" in name:
            # dense-tail layers (apply_tail): w [in, out], b [out]
            fi, fo = size
            params[f"w_{name}"] = (
                rng.randn(fi, fo).astype(np.float32) * np.sqrt(2.0 / fi)).astype(np.float32)
            params[f"b_{name}"] = np.zeros(fo, np.float32)
    return params


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None,
                     help="torch device; the card ('cuda') when not given")
    dev_args, argv = pre.parse_known_args(argv)
    parser = build_parser()
    parser.add_argument("--train_steps", type=int, default=200)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--save_to", type=str, required=True,
                        help="Output checkpoint path (.npz).")
    parser.add_argument("--log_every", type=int, default=20)
    parser.add_argument("--checkpoint_every", type=int, default=0,
                        help="Also save the checkpoint every N steps "
                             "(0 = only at the end) — crash recovery for "
                             "long runs.")
    parser.add_argument("--resume_from", type=str, default=None,
                        help="Initialize weights from an existing "
                             "checkpoint (.npz / TF bundle) instead of "
                             "random — continue an interrupted run or "
                             "fine-tune.  When the sibling <ckpt>.opt.npz "
                             "(written by either package's CLI) exists, "
                             "the optimizer state (Adam moments + step "
                             "count) is restored too, so the resumed loss "
                             "trajectory matches the uninterrupted run; "
                             "otherwise moments restart (fine-tune "
                             "semantics).")
    args, _ = parser.parse_known_args(argv)
    if args.config:
        import yaml

        with open(args.config) as f:
            file_cfg = yaml.safe_load(f) or {}
        from async_ev_cnn_torch.utils.config import layers_dict

        if isinstance(file_cfg.get("yolo_cnn_layers"), str):
            file_cfg["yolo_cnn_layers"] = layers_dict(file_cfg["yolo_cnn_layers"])
        dests = {a.dest for a in parser._actions}
        unknown = sorted(set(file_cfg) - dests)
        if unknown:
            # same contract as utils.config.config(): a typo'd YAML key
            # must not silently fall back to the default
            raise ValueError(f"unknown config keys: {unknown}")
        parser.set_defaults(**file_cfg)
        args, _ = parser.parse_known_args(argv)
    if args.train_steps < 1:
        raise SystemExit("--train_steps must be >= 1")
    args.log_every = max(1, args.log_every)
    if getattr(args, "keep_polarity", False):
        raise SystemExit(
            "train integrates 1-channel frames (polarity dropped, like "
            "the reference runner); 2-channel training is not supported"
        )

    import torch

    from async_ev_cnn_torch.layers.network import EventNetwork
    from async_ev_cnn_torch.models.train import (
        Trainer, YoloTargets, restore_adam_state, save_adam_state)
    from async_ev_cnn_torch.ops.conv import set_matmul_precision
    from async_ev_cnn_torch.ops.integrate import integrate_frame_chunked
    from async_ev_cnn_torch.utils.checkpoint import save_params
    from async_ev_cnn_torch.utils.device import resolve_device
    from async_ev_cnn_torch.utils.weights import params_from_jax, params_to_jax

    device = resolve_device(dev_args.device)
    set_matmul_precision(args.matmul_precision)
    reader = detection_reader.factory(args.input_data_dir, file_format=args.file_format)
    num_classes = reader.num_classes()
    sh, sw = args.yolo_num_cells_h, args.yolo_num_cells_w

    net = EventNetwork(args.yolo_cnn_layers, args.frame_h, args.frame_w,
                       leak=args.leak, alpha=0.1, padding=args.yolo_cnn_padding)
    params = init_params(args.yolo_cnn_layers)
    if args.resume_from:
        from async_ev_cnn_torch.utils.checkpoint import load_params, normalize_names

        restored = normalize_names(load_params(args.resume_from))
        for k in params:
            if k not in restored:
                raise ValueError(
                    f"--resume_from checkpoint is missing {k!r} for the "
                    "configured layers"
                )
            if tuple(restored[k].shape) != tuple(params[k].shape):
                raise ValueError(
                    f"--resume_from {k!r}: checkpoint shape "
                    f"{restored[k].shape} != configured {params[k].shape}"
                )
            params[k] = np.asarray(restored[k], np.float32)
        print(f"resumed {len(params)} tensors from {args.resume_from}")
    params = params_from_jax(params, device)

    trainer = Trainer(net, num_classes=num_classes, num_bbox=args.yolo_num_bbox,
                      grid_shape=(sh, sw), learning_rate=args.learning_rate)
    opt_state = trainer.init(params)
    if args.resume_from:
        opt_ckpt = opt_state_path(args.resume_from)
        if os.path.exists(opt_ckpt):
            restore_adam_state(opt_ckpt, params, opt_state)
            print(f"resumed optimizer state from {opt_ckpt}")

    def save():
        save_params(args.save_to, params_to_jax(params))
        save_adam_state(opt_state_path(args.save_to), params, opt_state)

    loss = None
    for step in range(args.train_steps):
        # one batched fetch: next_batch engages its thread pool for
        # batch_size > 1
        batch = reader.next_batch(
            args.batch_size, dataset="train",
            preprocessing_fn=partial(_eval_transform, args=args),
            threads=args.reader_threads,
        )
        if args.batch_size == 1:
            lengths, examples = batch[0], [(batch[1], batch[2])]
        else:
            lengths, ev_pad, bb_pad = batch[0], batch[1], batch[2]
            # slice off the ragged zero-padding per example: a padding
            # row (y=0, x=0, ts=0) would integrate as a real event
            examples = [(ev_pad[i, : int(lengths[i])], bb_pad[i])
                        for i in range(args.batch_size)]
        # the frames stay on the device: one stack, no host round trip
        frames = torch.stack([
            integrate_frame_chunked(events, args.leak, args.frame_h, args.frame_w,
                                    device=device)[0]
            for events, _ in examples])
        grids = [build_targets(bb, sh, sw) for _, bb in examples]
        targets = YoloTargets(*(torch.from_numpy(np.stack(t)).to(device) for t in zip(*grids)))
        params, opt_state, loss = trainer.step(params, opt_state, frames, targets)
        if step % args.log_every == 0:
            print(f"step {step:5d}: loss {float(loss):.4f}")
        if args.checkpoint_every and (step + 1) % args.checkpoint_every == 0:
            save()

    save()
    print(json.dumps({"final_loss": float(loss), "checkpoint": args.save_to,
                      "steps": args.train_steps}))
    return float(loss)


if __name__ == "__main__":
    main()
