"""The benchmark's inputs, arithmetic and reference, on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import work
from portbench.inputs import Traffic, make_weights
from portbench.reference import efcn as ref
from portbench.run import load

from .conftest import REPO, TINY_LAYERS

EFCN = {"conv1": [3, 3, 1, 16], "pool1": [2, 2], "conv2": [3, 3, 16, 32], "pool2": [2, 2],
        "conv3": [3, 3, 32, 64], "pool3": [2, 2], "conv4": [3, 3, 64, 128], "pool4": [2, 2],
        "conv5": [3, 3, 128, 256], "pool5": [2, 2], "conv6": [1, 1, 256, 512],
        "conv7": [1, 1, 512, 110]}

MIXES = {
    "closed": {"loop": "closed", "streams": 3, "chunks": 2, "events_per_chunk": 8,
               "pixels": "clustered", "radius": 4, "ts_gap_us": [1, 14], "pool": 2,
               "warmup_requests": 1},
    "open": {"loop": "open", "streams": 1, "chunks": 2, "events_per_chunk": 8,
             "pixels": "uniform", "rate_events_per_s": 3_000_000, "pool": 2,
             "warmup_requests": 1},
}


def _traffic(mix, seed):
    return Traffic(mix, seed, 16, 24, load(REPO, "pixels", mix["pixels"]).events)


@pytest.mark.parametrize("kind", sorted(MIXES))
def test_traffic_is_fixed_by_the_seed(kind):
    seed = 2**31 + 12345  # seeds may pass 32 signed bits
    a, b = _traffic(MIXES[kind], seed), _traffic(MIXES[kind], seed)
    c = _traffic(MIXES[kind], seed + 1)
    items = [(k, s) for k in range(5) for s in range(a.streams)]
    assert all(np.array_equal(a.item(k, s), b.item(k, s)) for k, s in items)
    assert not all(np.array_equal(a.item(k, s), c.item(k, s)) for k, s in items)
    for s in range(a.streams):  # every stream's time runs forward across items
        ts = np.concatenate([a.item(k, s)[:, 2] for k in range(5)])
        assert (np.diff(ts) >= 0).all() and ts.min() >= 0
    assert all(len(a.item(k, 0)) == 16 for k in range(5))


def test_open_loop_timestamps_follow_the_rate():
    mix = MIXES["open"]
    tr = _traffic(mix, 7)
    ts = np.concatenate([tr.item(k, 0)[:, 2] for k in range(4)])
    n = np.arange(64)
    assert np.array_equal(ts, n * 1_000_000 // mix["rate_events_per_s"])
    # request k is due when its last event is, counted from the first measured event
    assert tr.due_s(1) == pytest.approx((31 * 1e6 // 3e6 - 16 * 1e6 // 3e6) / 1e6)


def test_weights_are_fixed_by_the_seed():
    a = make_weights(TINY_LAYERS, 2**33 + 5, "cpu")
    b = make_weights(TINY_LAYERS, 2**33 + 5, "cpu")
    c = make_weights(TINY_LAYERS, 2**33 + 6, "cpu")
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["w_conv2"], c["w_conv2"])
    assert tuple(a["w_conv2"].shape) == (8, 4, 3, 3) and tuple(a["b_conv3"].shape) == (7,)


def test_the_efcn_frame_flops():
    # conv1 10,321,920 + four 82,575,360 + conv6 9,175,040 + conv7 3,942,400
    assert work.frame_flops(EFCN, 160, 224) == 353_740_800
    assert [c[:2] for c in work.conv_layers(EFCN, 160, 224)] == [
        (160, 224), (80, 112), (40, 56), (20, 28), (10, 14), (5, 7), (5, 7)]


def test_integrate_bytes_of_a_dispatch():
    # 16 streams x 64 chunks x 200 slots of 13 B, 1,024 surfaces written and
    # 16 read, of 160 x 224 float32
    n = work.integrate_bytes(16 * 64 * 200, 16 * 64, 16, 160 * 224)
    assert n == 204_800 * 13 + 4 * 35_840 * 1_040


def test_rulebook_work_counts_what_the_active_sites_need():
    active = torch.zeros(6, 9, dtype=torch.bool)
    active[2, 3] = active[2, 4] = active[5, 8] = True
    flops, n_bytes = work.rulebook_work(active, 3, 3, 5, 7)
    assert flops == 2 * 2 * 3 * 9 * 5 * 7
    # padded input pixels read: a 3 x 4 box for the pair, a 3 x 3 box for the corner
    inputs = 3 * 4 + 3 * 3
    assert n_bytes == 4 * (2 * inputs * 5 + 9 * 5 * 7 + 7 + 2 * 3 * 7)
    assert work.rulebook_work(torch.zeros(4, 4, dtype=torch.bool), 3, 3, 5, 7) == (0, 0)
    assert work.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert work.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def _chunks(seed, s, t, e, h, w):
    rng = np.random.default_rng(seed)
    ts = np.cumsum(rng.integers(1, 15, size=(s, t * e)), axis=1).reshape(s, t, e)
    y = rng.integers(0, h, size=(s, t, e))
    y[:, :, :e // 2] = y[:, :, e // 2:]  # duplicated pixels: the latest event wins
    x = rng.integers(0, w, size=(s, t, e))
    x[:, :, :e // 2] = x[:, :, e // 2:]
    valid = np.ones((s, t, e), bool)
    valid[:, 1, e - 3:] = False  # a ragged chunk
    return [torch.from_numpy(a) for a in (y, x, ts, valid)]


def test_reference_surfaces_are_the_programs_bit_for_bit():
    from async_ev_cnn_torch.layers.types import EventChunk
    from async_ev_cnn_torch.ops.integrate import integrate_parallel

    s, t, e, h, w, leak = 2, 5, 12, 8, 10, 5e-3
    y, x, ts, valid = _chunks(3, s, t, e, h, w)
    chain = ref.SurfaceChain(s, h, w, leak, "cpu")
    first = chain.run(y[:, :3], x[:, :3], ts[:, :3], valid[:, :3], keep=[0, 2])
    rest = chain.run(y[:, 3:], x[:, 3:], ts[:, 3:], valid[:, 3:], keep=[0, 1])
    mine = torch.cat([first, rest], dim=1)
    chunks = EventChunk(y.int(), x.int(), ts.int(), torch.zeros_like(y).int(), valid)
    theirs, last = integrate_parallel(torch.zeros(s, 1, h, w), torch.zeros(s, dtype=torch.int32),
                                      chunks, leak)
    assert torch.equal(mine, theirs[:, [0, 2, 3, 4], 0])
    assert torch.equal(chain.prev_ts, last[:, -1].long())


def test_reference_network_and_head_are_the_programs():
    from async_ev_cnn_torch.layers.network import EventNetwork
    from async_ev_cnn_torch.models import head

    weights = make_weights(TINY_LAYERS, 11, "cpu")
    net = EventNetwork(TINY_LAYERS, 16, 24, 5e-5, 0.1, "SAME", conv_mode="full")
    frames = torch.rand(6, 1, 16, 24) * 3
    theirs = net.full_frame_forward(weights, net.init_state(weights, "cpu"), frames)
    mine = ref.dense_grid(frames, weights, TINY_LAYERS, 0.1)
    assert mine.shape == theirs.shape == (6, 4, 6, 7)
    assert torch.allclose(mine, theirs, rtol=1e-5, atol=1e-6)
    boxes, _, probs = head.decode(theirs, 2, 1, 16, 24)
    my_boxes, my_probs = ref.decode(theirs, 2, 1, 16, 24)
    assert torch.equal(my_boxes, boxes) and torch.equal(my_probs, probs)


def test_the_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path

    root = Path(ref.__file__).parent
    for path in root.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in (
                    "async_ev_cnn_torch", "async_ev_cnn_tpu", "jax", "portbench"), (path, name)


def test_a_trace_reduces_to_range_time_busy_time_and_gaps():
    from portbench.tracing import WINDOW_RANGE, TraceEvents

    spans = [(WINDOW_RANGE, 0, 100), ("conv_stack", 10, 20), ("conv_stack", 50, 60),
              ("integrate", 30, 40)]
    host = [("cudaLaunchKernel", 12, 13), ("cudaStreamSynchronize", 70, 90)]
    # (name, start, end, launch): launched inside a span or not, one record
    # without its launch, one past the window
    device = [("conv", 15, 25, 12), ("conv", 22, 35, 55), ("scan", 40, 45, 31),
              ("copy", 60, 61, None), ("late", 95, 110, 80)]
    tr = TraceEvents(spans, host, device)
    assert tr.range_device_ns("conv_stack") == (2, 23.0)
    assert tr.range_device_ns("integrate") == (1, 5.0)
    assert tr.range_device_ns("absent") == (0, 0.0)
    assert tr.window() == (0, 100)
    # busy: [15, 35], [40, 45], [60, 61], [95, 100]
    assert tr.busy_ns() == 20 + 5 + 1 + 5
    gaps = dict(tr.idle_gaps())
    # idle 0-15 begins in no span, 35-40 in integrate, 45-60 and 61-95 in none
    assert gaps == {"python": pytest.approx((15 + 15 + 34) / 1e9),
                    "integrate": pytest.approx(5 / 1e9)}
    assert tr.top_device_ops(2) == [["conv", 23 / 1e9], ["late", 15 / 1e9]]
