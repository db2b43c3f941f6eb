"""Standalone async-vs-dense equivalence check of the port.

Counterpart of ``async_ev_cnn_tpu/scripts/test_correctness.py``: the
reference's 2-conv/2-pool network with the fixed 3x3 kernel and bias 10 on
an 8x8 canvas, driven by a random stream of ``--iterations`` steps of 5
events; prints each layer's max |async - dense| and exits non-zero above
the 1e-4 budget.  Runs on the card unless ``--device cpu`` is given:

    python -m async_ev_cnn_torch.scripts.test_correctness --mode sparse_pallas
    python -m async_ev_cnn_torch.scripts.test_correctness --device cpu --iterations 1000
"""

from __future__ import annotations

import argparse
import sys
from collections import OrderedDict

import numpy as np

MODES = ("dense", "sparse", "sparse_pallas", "sparse_rows", "window", "full")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--iterations", type=int, default=10000)
    p.add_argument("--events_per_step", type=int, default=5)
    p.add_argument("--tolerance", type=float, default=1e-4)
    p.add_argument("--mode", default="dense", choices=MODES)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device; the card ('cuda') when not given")
    args = p.parse_args(argv)

    from async_ev_cnn_torch.layers.network import EventNetwork
    from async_ev_cnn_torch.utils.device import resolve_device
    from async_ev_cnn_torch.utils.equivalence import make_stream, run_equivalence
    from async_ev_cnn_torch.utils.weights import params_from_jax

    dev = resolve_device(args.device)
    k = np.array([[-2, -1, 1], [-2, -1, 1], [-2, -1, 1]], np.float32).reshape(3, 3, 1, 1)
    layer_defs = OrderedDict(
        [("conv1", [3, 3, 1, 1]), ("pool1", [2, 2]), ("conv2", [3, 3, 1, 1]), ("pool2", [2, 2])]
    )
    bias = np.array([10.0], np.float32)
    params = params_from_jax(
        {"w_conv1": k, "b_conv1": bias, "w_conv2": k, "b_conv2": bias}, dev)
    net = EventNetwork(layer_defs, 8, 8, leak=0.1, alpha=0.1, padding="SAME",
                       conv_mode=args.mode)
    rng = np.random.RandomState(args.seed)
    chunks = make_stream(rng, args.iterations, args.events_per_step, 8, 8, device=dev)
    report = run_equivalence(net, params, chunks, device=dev)

    ok = True
    for name, diff in report.max_diff.items():
        status = "OK " if diff <= args.tolerance else "FAIL"
        print(f"{status} {name:6s} max|async-dense| = {diff:.3e} "
              f"(worst step {report.worst_step[name]})")
        ok &= diff <= args.tolerance
    if ok:
        print(f"\nSUCCESS: async == dense to {args.tolerance} over "
              f"{args.iterations} steps on {dev}")
        return 0
    print("\nERROR: async/dense divergence above tolerance")
    return 1


if __name__ == "__main__":
    sys.exit(main())
