"""Configuration: YAML files with CLI overrides and the layer DSL.

Copied whole from ``async_ev_cnn_tpu/utils/config.py`` (framework-free), so
the port reads ``configs/*.yml`` as the JAX package does.  Capability
parity with the reference's configargparse setup (its
``src/scripts/config.py``): ``-c <yaml>`` plus flag overrides, the
``conv1=3,3,1,16 pool1=2,2 …`` layer DSL (config.py:6-12), and the same
flag set — without the configargparse dependency (plain argparse + pyyaml).
"""

from __future__ import annotations

import argparse
import os
from collections import OrderedDict

import yaml


class LayerDSL(OrderedDict):
    """Ordered layer-definition dict with optional per-layer conv modes.

    ``modes`` maps layer name -> conv execution mode for layers annotated
    with ``@mode`` in the DSL (e.g. ``conv1=3,3,1,16@window``).
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.modes: dict = {}


def layers_dict(text: str) -> "LayerDSL":
    """Parse the layer DSL: ``'conv1=3,3,1,16 pool1=2,2 fc1=128,64'``.

    Matches config.py:6-12 (space-separated ``name=dims`` items, dims
    comma-separated ints) plus an optional per-layer conv execution mode
    suffix: ``conv1=3,3,1,16@window``.
    """
    try:
        out = LayerDSL()
        for item in text.split(" "):
            if not item:
                continue
            name, eq, dims = item.partition("=")
            if not eq:
                # a typo'd separator would otherwise become a bogus
                # empty-dims layer that fails much later in layer build
                raise argparse.ArgumentTypeError(
                    f"layer item {item!r} has no '=' (expected "
                    "'name=h,w,i,o')"
                )
            dims, _, mode = dims.partition("@")
            out[name] = [int(d) for d in dims.split(",")] if dims else []
            if mode:
                out.modes[name] = mode
        return out
    except ValueError as e:
        raise argparse.ArgumentTypeError(
            "layer DSL must be 'name1=h1,w1,i1,o1 name2=h2,w2 ...' "
            f"(failed on {text!r}: {e})"
        )


def layers_dsl(layer_defs: "OrderedDict[str, list[int]]") -> str:
    """Inverse of :func:`layers_dict`."""
    modes = getattr(layer_defs, "modes", {})
    return " ".join(
        f"{k}={','.join(map(str, v))}" + (f"@{modes[k]}" if k in modes else "")
        for k, v in layer_defs.items()
    )


def boolean(v: str) -> bool:
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def stem_fusion_mode(v: str):
    """Tri-state for --stem_fusion: a boolean forces the fusion on/off at
    any tier; 'auto' fuses only in the measured-win regime ('default'
    matmul tier x f32 activation storage — see
    EventNetwork._fusion_active)."""
    if v.lower() == "auto":
        return "auto"
    return boolean(v)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="async-ev-cnn-tpu runner")
    p.add_argument("-c", "--config", default=None, help="YAML config file path")
    p.add_argument("--batch_size", type=int, default=1,
                   help="Examples per reader batch.")
    p.add_argument("--reader_threads", type=int, default=4,
                   help="Parallel reader workers.")
    p.add_argument("--input_data_dir", type=str, default="data/nmnist",
                   help="Dataset directory.")
    p.add_argument("--file_format", type=str, default="n-data",
                   help="'n-data', 'aer-data[_CAMERA]' or 'numpy'.")
    p.add_argument("--restore_net", type=str, default=None,
                   help="Checkpoint file/dir (.npz or TF v2 bundle).")
    p.add_argument("--network", type=str, default="YoloEventJax",
                   help="'YoloEventJax', 'YoloFrameJax' or 'YoloFrameNumpy'.")
    p.add_argument("--frame_h", type=int, default=124)
    p.add_argument("--frame_w", type=int, default=124)
    p.add_argument("--example_h", type=int, default=124)
    p.add_argument("--example_w", type=int, default=124)
    p.add_argument("--leak", type=float, default=0.00015,
                   help="Surface leak per microsecond.")
    p.add_argument("--frame_delay", type=int, default=50,
                   help="Delay (ms) between displayed frames.")
    p.add_argument("--yolo_cnn_layers", type=layers_dict, default=None,
                   help="Layer DSL, e.g. 'conv1=3,3,1,16 pool1=2,2 ...'.")
    p.add_argument("--yolo_cnn_padding", type=str, default="VALID")
    p.add_argument("--yolo_num_cells_h", type=int, default=4)
    p.add_argument("--yolo_num_cells_w", type=int, default=4)
    p.add_argument("--yolo_num_bbox", type=int, default=2)
    p.add_argument("--batch_event_size", type=int, default=1,
                   help="Events per micro-batch.")
    p.add_argument("--batch_event_usec", type=int, default=None,
                   help="Micro-batch by time window (overrides event count).")
    # TPU-native additions (not in the reference):
    p.add_argument("--mode", type=str, default="dense",
                   help="Conv execution: 'dense' (masked commit), 'sparse' / "
                        "'sparse_pallas' (rulebook gather->GEMM->scatter), "
                        "'window' (active-bounding-box), 'full' (recompute "
                        "everything — fastest exact mode below ~0.3 MPix), "
                        "or 'auto' (= 'full' for every layer — the measured network-level winner; docs/performance.md).")
    p.add_argument("--num_streams", type=int, default=1,
                   help="Independent event streams batched per step "
                        "(sharded over the device mesh when >1).")
    p.add_argument("--runner", type=str, default="step",
                   help="Event-network execution: 'step' (per-micro-batch "
                        "dispatch, latency mode) or 'scan' (whole example "
                        "fused into one lax.scan, throughput mode).")
    p.add_argument("--show_frames", type=boolean, default=False,
                   help="Display predictions with OpenCV.")
    p.add_argument("--keep_polarity", type=boolean, default=False,
                   help="Feed events as [y,x,ts,p] for 2-channel ON/OFF "
                        "surfaces (first conv in_channels=2); the reference "
                        "always drops polarity.")
    p.add_argument("--profile", type=boolean, default=False,
                   help="Capture a jax.profiler trace of the run.")
    p.add_argument("--ts_window", type=int, default=None,
                   help="parallel-in-time: compute per-chunk ts maps in a "
                        "square window of this many pixels around each "
                        "chunk's events (clustered-stream speedup; exact "
                        "fallback when a chunk overflows)")
    p.add_argument("--window_budget_mb", type=float, default=None,
                   help="parallel-in-time: derive the time-window size "
                        "(chunks per dispatch) from this activation-memory "
                        "budget via the network's memory model "
                        "(EventNetwork.auto_window) instead of the fixed "
                        "default window — bounded memory on arbitrarily "
                        "long streams.")
    p.add_argument("--stem_fusion", type=stem_fusion_mode, default="auto",
                   help="parallel-in-time: execute thin-stem (Cin<=2) "
                        "conv+pool pairs as one space-to-depth conv "
                        "(ops/stem.py).  'auto' (default) fuses only at "
                        "the 'default' (bf16) matmul tier with f32 "
                        "activation storage, where it measured a 1.15x "
                        "whole-step win (bit-exact); at f32 HIGHEST and "
                        "'high' it measured neutral at eFCN scale, under "
                        "bf16 activation storage a slight loss, and under "
                        "vmapped multi-stream serving a 1.41x regression "
                        "(the serving engine overrides 'auto' to off for "
                        "streams > 1) — 'true'/'false' force it.")
    p.add_argument("--activation_dtype", type=str, default="float32",
                   help="inter-layer activation storage for 'full'-mode "
                        "layers: 'float32' (default) or 'bfloat16' (halves "
                        "inter-layer HBM traffic; convs still accumulate "
                        "f32; the async==dense gate stays same-program, "
                        "like the matmul-precision tiers).")
    p.add_argument("--serve_chunks", type=int, default=64,
                   help="serve CLI: chunks per stream per dispatch (every "
                        "dispatch keeps this static shape; short items are "
                        "padded with exact no-op chunks).")
    p.add_argument("--serve_max_dispatches", type=int, default=None,
                   help="serve CLI: stop after this many dispatches "
                        "(default: one pass over the test split).")
    p.add_argument("--serve_wire", type=str, default="auto",
                   choices=("auto", "ultra4", "ultra", "compact", "plain"),
                   help="serve CLI: host->device wire format. 'auto' "
                        "uses the smallest tier each item fits — "
                        "2.5 B/event ultra4 (4-bit ts deltas), 3 B ultra "
                        "(u8 deltas), 4 B compact (u16 deltas), 8 B "
                        "plain — converting exactly upward when the "
                        "stream stops fitting (at most one compiled "
                        "program per tier era); 'plain' pins 8 B up "
                        "front; 'ultra4'/'ultra'/'compact' error if the "
                        "stream does not fit.")
    p.add_argument("--serve_state", type=str, default=None,
                   help="serve CLI: mid-stream state checkpoint path "
                        "(.npz). Restored at startup when the file "
                        "exists (crash/maintenance resume: surfaces, "
                        "timestamps and featuremaps continue "
                        "bit-identically), written atomically at exit.")
    p.add_argument("--out", type=str, default=None,
                   help="serve CLI: write decoded detections (host NMS) "
                        "as JSON lines to this path.")
    p.add_argument("--conf_threshold", type=float, default=0.2,
                   help="serve CLI: detection confidence threshold for "
                        "--out.")
    p.add_argument("--matmul_precision", type=str, default="highest",
                   help="MXU precision for convs/GEMMs: 'highest' (full f32, "
                        "the parity default), 'high', or 'default' (bf16 "
                        "operands, ~25%% faster, ~1e-2 absolute fidelity).")
    return p


def config(argv=None) -> argparse.Namespace:
    """Parse a config: YAML file values are defaults, CLI flags override."""
    parser = build_parser()
    args, _ = parser.parse_known_args(argv)
    if args.config:
        with open(args.config) as f:
            file_cfg = yaml.safe_load(f) or {}
        unknown = set(file_cfg) - {a.dest for a in parser._actions}
        if unknown:
            raise ValueError(f"unknown config keys in {args.config}: {sorted(unknown)}")
        if "yolo_cnn_layers" in file_cfg and isinstance(file_cfg["yolo_cnn_layers"], str):
            file_cfg["yolo_cnn_layers"] = layers_dict(file_cfg["yolo_cnn_layers"])
        parser.set_defaults(**file_cfg)
    # strict final parse: a misspelled flag (--batch_event_used) must not
    # be silently dropped while YAML keys get strict validation
    args = parser.parse_args(argv)
    return args
