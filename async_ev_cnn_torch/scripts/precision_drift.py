"""Long-horizon async-vs-dense drift against the matmul tier, on the card.

Counterpart of ``examples/tpu_precision_drift.py``: the reference's small
gate net (2 conv / 2 pool, 8x8, the fixed 3x3 kernel, bias 10) in conv
modes 'dense' and 'full', and the full-width eFCN (160x224, conv1..conv7,
leak 5e-5, seeded weights of scale 0.05) in 'full', over ``--steps``
steps, at the tiers 'highest', 'high' and 'default'; the eFCN in the
incremental 'dense' mode at 'highest' and 'default' (the cell where the
tier's rounding meets incremental state at full width); then the eFCN at
'default' with ``activation_dtype='bfloat16'``.  One JSON line per cell:
the per-layer max |async - dense| over all steps and whether it stays
within the reference's 1e-4.

The async side and the dense oracle run at the same tier, so the drift
measures how far the tier's rounding lets the incremental state wander
from a recomputation, not the distance to float32.  On the CPU the tier
changes nothing.  On the card a 'dense' cell's line also lists the conv
and GEMM kernels that three of its steps launch (from torch.profiler), so
whether the tier reached tensor cores (TF32 kernels) can be read there.

    python -m async_ev_cnn_torch.scripts.precision_drift            # 10,000 steps on the card
    python -m async_ev_cnn_torch.scripts.precision_drift --device cpu --steps 50
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import OrderedDict

import numpy as np

EFCN = ("conv1=3,3,1,16 pool1=2,2 conv2=3,3,16,32 pool2=2,2 conv3=3,3,32,64 "
        "pool3=2,2 conv4=3,3,64,128 pool4=2,2 conv5=3,3,128,256 pool5=2,2 "
        "conv6=1,1,256,512 conv7=1,1,512,110")


def small_net(conv_mode, device):
    from async_ev_cnn_torch.layers.network import EventNetwork
    from async_ev_cnn_torch.utils.weights import params_from_jax

    k = np.array([[-2, -1, 1]] * 3, np.float32).reshape(3, 3, 1, 1)
    layer_defs = OrderedDict(
        [("conv1", [3, 3, 1, 1]), ("pool1", [2, 2]),
         ("conv2", [3, 3, 1, 1]), ("pool2", [2, 2])])
    b = np.array([10.0], np.float32)
    params = params_from_jax({"w_conv1": k, "b_conv1": b, "w_conv2": k, "b_conv2": b},
                             device)
    net = EventNetwork(layer_defs, 8, 8, leak=0.1, alpha=0.1, padding="SAME",
                       conv_mode=conv_mode)
    return net, params


def efcn_net(device, activation_dtype="float32", conv_mode="full"):
    from async_ev_cnn_torch.layers.network import EventNetwork
    from async_ev_cnn_torch.utils.config import layers_dict
    from async_ev_cnn_torch.utils.weights import params_from_jax

    defs = layers_dict(EFCN)
    rng = np.random.RandomState(0)
    params = {}
    for name, size in defs.items():
        if "conv" in name:
            kh, kw, ci, co = size
            params[f"w_{name}"] = rng.randn(kh, kw, ci, co).astype(np.float32) * 0.05
            params[f"b_{name}"] = rng.randn(co).astype(np.float32) * 0.05
    net = EventNetwork(defs, 160, 224, leak=5e-5, alpha=0.1, padding="SAME",
                       conv_mode=conv_mode, activation_dtype=activation_dtype)
    return net, params_from_jax(params, device)


def conv_kernels(net, params, stream, device, steps: int = 3) -> list:
    """The distinct conv and GEMM kernels (cuDNN, cuBLAS) that ``steps``
    steps of the cell launch on the card, by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from async_ev_cnn_torch.layers.types import EventChunk
    from async_ev_cnn_torch.utils.equivalence import run_equivalence

    few = EventChunk(*(f[:steps] for f in stream))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_equivalence(net, params, few, device=device)
        torch.cuda.synchronize()
    keys = ("conv", "gemm", "xmma", "cudnn", "cutlass", "tf32")
    return sorted({e.key[:120] for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and any(k in e.key.lower() for k in keys)})


def drift_line(cell: dict, net, params, stream, device) -> dict:
    """Run one cell and return its JSON-ready line."""
    from async_ev_cnn_torch.utils.equivalence import run_equivalence

    t0 = time.perf_counter()
    rep = run_equivalence(net, params, stream, device=device)
    worst = max(rep.max_diff.values())
    line = {**cell, "max_diff": worst, "pass_1e-4": bool(worst <= 1e-4),
            "per_layer": dict(rep.max_diff), "seconds": time.perf_counter() - t0}
    if device.type == "cuda" and cell["mode"] == "dense":
        kernels = conv_kernels(net, params, stream, device)
        line["conv_kernels"] = kernels
        line["tf32_kernels"] = sum("tf32" in k.lower() for k in kernels)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=10_000)
    p.add_argument("--device", default=None,
                   help="torch device; the card ('cuda') when not given")
    args = p.parse_args(argv)

    from async_ev_cnn_torch.ops.conv import set_matmul_precision
    from async_ev_cnn_torch.utils.device import resolve_device
    from async_ev_cnn_torch.utils.equivalence import make_stream

    dev = resolve_device(args.device)
    rng = np.random.RandomState(7)
    small_stream = make_stream(rng, args.steps, 5, 8, 8, device=dev)
    efcn_stream = make_stream(rng, args.steps, 200, 160, 224, max_dt=30, device=dev)
    where = {"device": str(dev), "steps": args.steps}
    try:
        for precision in ("highest", "high", "default"):
            set_matmul_precision(precision)
            for mode in ("dense", "full"):
                net, params = small_net(mode, dev)
                print(json.dumps(drift_line(
                    {"scale": "small_8x8", "mode": mode, "precision": precision, **where},
                    net, params, small_stream, dev)), flush=True)
            for mode in ("full", "dense") if precision != "high" else ("full",):
                net, params = efcn_net(dev, conv_mode=mode)
                print(json.dumps(drift_line(
                    {"scale": "efcn_160x224", "mode": mode, "precision": precision, **where},
                    net, params, efcn_stream, dev)), flush=True)
        set_matmul_precision("default")
        net, params = efcn_net(dev, activation_dtype="bfloat16")
        print(json.dumps(drift_line(
            {"scale": "efcn_160x224", "mode": "full", "precision": "default",
             "activation_dtype": "bfloat16", **where},
            net, params, efcn_stream, dev)), flush=True)
    finally:
        set_matmul_precision("highest")
    return 0


if __name__ == "__main__":
    sys.exit(main())
