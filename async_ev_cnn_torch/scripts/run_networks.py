"""CLI entry point: run a network over a dataset's test split.

    python -m async_ev_cnn_torch.scripts.run_networks -c configs/efcn_event.yml
    python -m async_ev_cnn_torch.scripts.run_networks ... --device cpu   # on the CPU

Counterpart of ``async_ev_cnn_tpu/scripts/run_networks.py``, with its flags
plus ``--device`` (the card, ``cuda``, when not given; raises where there
is none).  The network class is selected by the config's name: the JAX
package's ``YoloEventJax`` and ``YoloFrameJax`` (and the reference's
``YoloEventNumpy`` and ``YoloFrameTf``, their aliases there) run as
:class:`~async_ev_cnn_torch.models.yolo.YoloEventTorch` and
:class:`~async_ev_cnn_torch.models.yolo.YoloFrameTorch`, whose own names
are accepted too; ``YoloFrameNumpy`` is the numpy oracle.  ``--runner
step`` feeds one micro-batch a call (``EventRunner``/``FrameRunner``),
``--runner scan`` one example a call (``ScanEventRunner``); both print one
JSON stats line.  ``--profile`` writes a ``torch.profiler`` Chrome trace
to ``./torch_trace``.  ``--num_streams S`` (S > 1) serves S examples at
once through :class:`~async_ev_cnn_torch.utils.runner.MultiStreamRunner`:
in one process a world of 1 (every stream on the stream axis of one
device); under ``torchrun`` its ranks, or with ``--num_ranks N`` N ranks
that this command starts on the host (``parallel/launch.py``; NCCL on the
card, which takes one rank a card, gloo with ``--device cpu``):

    torchrun --nproc_per_node 4 -m async_ev_cnn_torch.scripts.run_networks -c CFG --num_streams 8
    python -m async_ev_cnn_torch.scripts.run_networks -c CFG --num_streams 4 --num_ranks 2 --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys

from async_ev_cnn_torch.data import detection_reader
from async_ev_cnn_torch.models.yolo import YoloEventTorch, YoloFrameNumpy, YoloFrameTorch
from async_ev_cnn_torch.utils.config import config

_NETWORKS = {
    "YoloEventTorch": YoloEventTorch,
    "YoloFrameTorch": YoloFrameTorch,
    "YoloFrameNumpy": YoloFrameNumpy,
    # the JAX package's names, and the reference's names it aliases
    "YoloEventJax": YoloEventTorch,
    "YoloFrameJax": YoloFrameTorch,
    "YoloEventNumpy": YoloEventTorch,
    "YoloFrameTf": YoloFrameTorch,
}

TRACE_DIR = "./torch_trace"


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None,
                     help="torch device; the card ('cuda') when not given")
    pre.add_argument("--num_ranks", type=int, default=1,
                     help="ranks to start on this host for --num_streams > 1")
    dev_args, rest = pre.parse_known_args(argv)
    args = config(rest)

    from async_ev_cnn_torch.ops.conv import set_matmul_precision
    from async_ev_cnn_torch.utils.device import resolve_device
    from async_ev_cnn_torch.utils.profiling import trace
    from async_ev_cnn_torch.utils.runner import EventRunner, FrameRunner, ScanEventRunner

    device = resolve_device(dev_args.device)
    set_matmul_precision(args.matmul_precision)
    if args.yolo_cnn_layers is None:
        raise SystemExit(
            "no network layers configured: pass -c <config.yml> or "
            "--yolo_cnn_layers"
        )
    layer_modes = set(getattr(args.yolo_cnn_layers, "modes", {}).values())
    incremental = {args.mode, *layer_modes} - {"full", "auto"}
    is_event_net = "Event" in args.network
    if args.matmul_precision == "default" and incremental and is_event_net:
        print(
            "WARNING: --matmul_precision default with incremental conv "
            f"mode(s) {sorted(incremental)}: the async-vs-dense gate drifts "
            "past 1e-4 at TF32 (the full-width 'dense' gate within 200 "
            "steps on the card) — use 'high' or 'highest' with incremental "
            "modes.  'full'/'auto' hold the gate exactly at every tier.",
            file=sys.stderr,
        )

    reader = detection_reader.factory(args.input_data_dir, file_format=args.file_format)

    try:
        network_class = _NETWORKS[args.network]
    except KeyError:
        raise SystemExit(
            f"unknown network {args.network!r}; choose one of {sorted(_NETWORKS)}"
        )

    def build(device):
        return network_class(
            h_frame=args.frame_h, w_frame=args.frame_w,
            num_classes=reader.num_classes(), cnn_layers=args.yolo_cnn_layers,
            cnn_padding=args.yolo_cnn_padding, h_cells=args.yolo_num_cells_h,
            w_cells=args.yolo_num_cells_w, num_bbox=args.yolo_num_bbox,
            alpha=0.1, leak=args.leak, checkpoint=args.restore_net,
            conv_mode=args.mode, ts_window=args.ts_window,
            stem_fusion=args.stem_fusion, window_budget_mb=args.window_budget_mb,
            activation_dtype=args.activation_dtype,
            **({} if network_class is YoloFrameNumpy else {"device": device}),
        )

    if args.num_streams > 1:
        if network_class is not YoloEventTorch:
            raise SystemExit("--num_streams > 1 requires an event network")
        if args.ts_window:
            # the JAX CLI's refusal (there vmap turns the window's exact
            # fallback into a both-branches select), kept for the same flags
            raise SystemExit(
                "--ts_window is a per-stream dispatch knob; it does not "
                "compose with --num_streams > 1")
        return _serve_streams(args, dev_args, rest, reader, build, device)
    if dev_args.num_ranks > 1:
        raise SystemExit("--num_ranks takes --num_streams > 1")
    network = build(device)

    if args.runner == "scan":
        if not isinstance(network, YoloEventTorch):
            raise SystemExit("--runner scan requires an event network")
        if args.batch_size > 1:
            raise SystemExit(
                "--runner scan streams one example per fused scan; use "
                "scripts/serve.py for multi-stream serving instead of "
                "--batch_size"
            )
        runner = ScanEventRunner(args, reader, device=device)
        model = network
    elif args.runner == "step":
        model = network.build_graph(None)
        runner_cls = EventRunner if isinstance(network, YoloEventTorch) else FrameRunner
        runner = runner_cls(args, reader, device=device)
    else:
        raise SystemExit(f"--runner must be 'step' or 'scan', got {args.runner!r}")

    with trace(TRACE_DIR if args.profile else None):
        stats = runner.run(model)
    if args.profile:
        print(f"profiler trace written to {TRACE_DIR}")
    print(json.dumps(stats))
    return stats


def _serve_streams(args, dev_args, argv, reader, build, device):
    """``--num_streams > 1``: the multi-stream runner over this process's
    ranks, or over ``--num_ranks`` ranks started here (rank 0's stats).
    The world starts before the network is built, so each rank builds it
    on its own card; the parent of ``--num_ranks`` builds none."""
    import torch.distributed as dist

    from async_ev_cnn_torch.parallel import world
    from async_ev_cnn_torch.utils.profiling import trace
    from async_ev_cnn_torch.utils.runner import MultiStreamRunner

    if dev_args.num_ranks > 1 and not dist.is_initialized():
        from async_ev_cnn_torch.parallel.launch import launch

        rank_argv = list(argv) + (["--device", dev_args.device] if dev_args.device else [])
        stats = launch(_rank_main, dev_args.num_ranks, args=(rank_argv,),
                       backend="nccl" if device.type == "cuda" else "gloo")[0]
        print(json.dumps(stats))
        return stats
    with world(device) as rank_device:
        network = build(rank_device)
        with trace(TRACE_DIR if args.profile else None):
            stats = MultiStreamRunner(args, reader, device=rank_device).run(network)
        rank = dist.get_rank()
    if args.profile:
        print(f"profiler trace written to {TRACE_DIR}")
    if rank == 0:
        print(json.dumps(stats))
    return stats


def _rank_main(argv):
    """One rank of ``--num_ranks``: the command on this rank, its lines
    kept off the terminal (the parent prints rank 0's stats)."""
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


if __name__ == "__main__":
    main()
