"""The port's window memory model (EventNetwork.parallel_live_bytes_per_chunk
and auto_window, async_ev_cnn_torch/layers/network.py) held against the
peak of its own eager ``scan_parallel``: the twin of
tests/test_memory_model.py, at its three off-calibration geometries.

The JAX test holds the model against XLA's compile-time ``temp_size``.
The port has no compiler plan to read, so the measure here is the CPU
allocator's: torch.profiler's per-op allocation record, summed in time
order, gives the peak of live bytes during one call; minus what the call
leaves allocated (its outputs) it is the counterpart of ``temp_size``.
chip_smoke.py's memory-model phase takes the same measure on the card
(``torch.cuda.max_memory_allocated``), where eager PyTorch keeps the same
tensors alive.  Bounds (the JAX test's): ``2 * model * T`` covers the peak
without outputs, and ``model * T`` is at most 30 times it.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from async_ev_cnn_torch.layers.network import EventNetwork
from async_ev_cnn_torch.utils.config import layers_dict
from async_ev_cnn_torch.utils.runner import pack_chunks
from async_ev_cnn_torch.utils.weights import params_from_jax

torch.set_num_threads(2)

GEOMETRIES = [
    ("thin_stem_64x96", "conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,8", 64, 96),
    ("deep_32x48",
     "conv1=3,3,1,8 pool1=2,2 conv2=3,3,8,16 pool2=2,2 conv3=3,3,16,32 "
     "pool3=2,2 conv4=1,1,32,16", 32, 48),
    ("polarity_48x48", "conv1=3,3,2,8 pool1=2,2 conv2=1,1,8,12", 48, 48),
]


def _params(layer_defs, rng):
    out = {}
    for name, size in layer_defs.items():
        if "conv" in name:
            out[f"w_{name}"] = rng.randn(*size).astype(np.float32) * 0.1
            out[f"b_{name}"] = rng.randn(size[3]).astype(np.float32) * 0.1
    return params_from_jax(out, "cpu")


def _peak_bytes(fn):
    """``fn()``'s peak of live CPU bytes above where it started, and the
    bytes it leaves allocated (its outputs)."""
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        fn()
    events = sorted((e for e in prof.profiler.function_events if e.self_cpu_memory_usage),
                    key=lambda e: e.time_range.start)
    live = peak = 0
    for e in events:
        live += e.self_cpu_memory_usage
        peak = max(peak, live)
    return peak, live


@pytest.mark.parametrize("name,dsl,h,w", GEOMETRIES)
def test_auto_window_model_covers_measured_peak(rng, name, dsl, h, w):
    t, cap = 24, 16
    net = EventNetwork(layers_dict(dsl), h, w, leak=1e-4, alpha=0.1, padding="SAME",
                       conv_mode="full")
    params = _params(layers_dict(dsl), rng)
    state = net.init_state(params, "cpu")
    n = t * cap
    cols = [rng.randint(0, h, n), rng.randint(0, w, n), np.sort(rng.randint(1, 5000, n))]
    if net.event_layers[0].spec.channels == 2:
        cols.append(rng.randint(0, 2, n))
    chunks = pack_chunks(np.stack(cols, axis=-1).astype(np.int32), cap, device="cpu")
    kept = []
    peak, outputs = _peak_bytes(lambda: kept.append(net.scan_parallel(params, state, chunks)))
    measured = peak - outputs
    assert measured > 0 and outputs > 0
    model = net.parallel_live_bytes_per_chunk()
    assert 2 * model * t >= measured, (
        f"{name}: auto_window would over-pack the budget: 2 * {model} B/chunk * {t} "
        f"< measured {measured} B")
    assert model * t <= 30 * measured, (
        f"{name}: model {model * t} B is >30x the measured {measured} B")


def test_auto_window_respects_budget_boundaries():
    """auto_window's arithmetic: the window fits the budget under the
    model, None when everything fits, never 0."""
    net = EventNetwork(layers_dict("conv1=3,3,1,4 pool1=2,2 conv2=1,1,4,8"), 32, 32,
                       leak=1e-4, alpha=0.1, padding="SAME", conv_mode="full")
    per = net.parallel_live_bytes_per_chunk()
    budget_mb = 10 * 2 * per / 2**20
    win = net.auto_window(1000, budget_mb)
    assert win is not None and 1 <= win <= 10
    assert 2 * per * win <= budget_mb * 2**20
    assert net.auto_window(win, budget_mb) is None
    assert net.auto_window(1000, 1e-9) == 1
