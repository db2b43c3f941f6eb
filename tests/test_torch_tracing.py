"""The port's span recorder (async_ev_cnn_torch/utils/profiling.py: span,
recording, recorded, clear), the spans the program puts at its layer
boundaries, the completion stamp of StreamingPipeline.latency_stats(), and
the benchmark's readers of those spans (portbench/program_spans.py).

CPU only, and no JAX: the recorder has no twin in the JAX package.
"""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from async_ev_cnn_torch.layers.network import EventNetwork
from async_ev_cnn_torch.layers.types import EventChunk
from async_ev_cnn_torch.models.yolo import YoloEventTorch
from async_ev_cnn_torch.utils import profiling
from async_ev_cnn_torch.utils import serving
from async_ev_cnn_torch.utils.config import layers_dict

torch.set_num_threads(2)

H = W = 16
CAP = 32
DSL = "conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,8 pool2=2,2 conv3=1,1,8,12"
LAYERS = ["layer.conv1", "layer.pool1", "layer.conv2", "layer.pool2", "layer.conv3",
          "layer.tail"]
# the parallel path's: each pool runs in its conv's epilogue, under its span
FUSED_LAYERS = ["layer.conv1", "layer.conv2", "layer.conv3", "layer.tail"]


@pytest.fixture(autouse=True)
def _empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


def _params(seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, size in layers_dict(DSL).items():
        if "conv" in name:
            kh, kw, cin, cout = size
            out[f"w_{name}"] = torch.randn(cout, cin, kh, kw, generator=g) * 0.3
            out[f"b_{name}"] = torch.randn(cout, generator=g) * 0.1
    return out


def _items(n, seed=0, events=2 * CAP):
    rng = np.random.RandomState(seed)
    items, t0 = [], 0
    for _ in range(n):
        ts = t0 + np.cumsum(rng.randint(1, 20, events))
        t0 = int(ts[-1]) + 1
        items.append(np.stack([rng.randint(0, H, events), rng.randint(0, W, events), ts],
                              axis=-1).astype(np.int32))
    return items


def _pipe(**kw):
    net = EventNetwork(layers_dict(DSL), H, W, 1e-4, 0.1, "SAME", conv_mode="full")
    return serving.StreamingPipeline(net, _params(), capacity=CAP, t_chunks=2,
                                     device="cpu", **kw)


def _model(mode="sparse_pallas"):
    m = YoloEventTorch(h_frame=H, w_frame=W, num_classes=7, cnn_layers=layers_dict(DSL),
                       cnn_padding="SAME", h_cells=4, w_cells=4, num_bbox=1, alpha=0.1,
                       leak=1e-4, conv_mode=mode, capacity_frac=0.1, device="cpu")
    m.params.update(_params())
    return m


def _chunks(n, seed=1, events=CAP):
    return [EventChunk.from_arrays(ev[:, 0], ev[:, 1], ev[:, 2], capacity=CAP, device="cpu")
            for ev in _items(n, seed, events)]


def _by_name(spans, name):
    return [s for s in spans if s[0] == name]


def test_a_span_off_reads_no_clock_and_records_nothing(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(time, "time_ns", no_clock)
    assert not torch.autograd.profiler._is_profiler_enabled
    first = profiling.span("a")
    assert profiling.span("b", request=3) is first  # one shared null context
    with first:
        with profiling.span("c"):
            pass
    assert profiling.recorded() == [] and profiling.dropped() == 0


def test_recording_and_a_profiler_session_turn_recording_on_and_off():
    with profiling.span("off"):
        pass
    with profiling.recording():
        with profiling.span("in.block"):
            pass
        with profiling.recording():  # blocks nest
            pass
        with profiling.span("still.in.block"):
            pass
    with profiling.span("off.again"):
        pass
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with profiling.span("in.profiler"):
        pass
    prof.stop()
    with profiling.span("after.profiler"):
        pass
    names = [s[0] for s in profiling.recorded()]
    assert names == ["in.block", "still.in.block", "in.profiler"]
    for _, t0, t1, parent, request, thread in profiling.recorded():
        assert 0 < t0 <= t1 and parent is None and request is None
        assert thread == threading.get_ident()


def test_parents_requests_and_threads_of_nested_spans():
    barrier = threading.Barrier(2)

    def work(tag):
        with profiling.span(f"{tag}.outer", request=tag):
            barrier.wait()  # both outer spans open at once, on two threads
            with profiling.span(f"{tag}.inner"):
                with profiling.span(f"{tag}.leaf", request=99):
                    pass
            barrier.wait()

    with profiling.recording():
        threads = [threading.Thread(target=work, args=(t,)) for t in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        with profiling.span("main"):
            pass
    spans = profiling.recorded()
    index = {s[0]: i for i, s in enumerate(spans)}
    idents = set()
    for tag in (1, 2):
        outer, inner, leaf = (spans[index[f"{tag}.{n}"]] for n in ("outer", "inner", "leaf"))
        assert outer[3] is None and outer[4] == tag
        assert inner[3] == index[f"{tag}.outer"] and inner[4] == tag  # inherited
        assert leaf[3] == index[f"{tag}.inner"] and leaf[4] == 99  # given
        assert outer[5] == inner[5] == leaf[5] != threading.get_ident()
        assert outer[1] <= inner[1] <= leaf[1] <= leaf[2] <= inner[2] <= outer[2]
        idents.add(outer[5])
    assert len(idents) == 2
    assert spans[index["main"]][3] is None and spans[index["main"]][5] == threading.get_ident()


def test_the_bound_drops_and_counts(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_LIMIT", 3)
    with profiling.recording():
        with profiling.span("a"):
            with profiling.span("b"):
                pass
            with profiling.span("c"):
                with profiling.span("d"):
                    pass
        with profiling.span("e"):  # a, closed after the bound, and e are dropped
            pass
    spans = profiling.recorded()
    assert [s[0] for s in spans] == ["b", "c", "d"] and profiling.dropped() == 2
    # a dropped parent is None; a kept one is indexed in the list
    assert [s[3] for s in spans] == [None, None, 1]
    profiling.clear()
    assert profiling.recorded() == [] and profiling.dropped() == 0


def test_the_bound_holds_under_many_threads(monkeypatch):
    import sys

    threads, each = 16, 400
    monkeypatch.setattr(profiling, "SPAN_LIMIT", threads * each // 2)
    start = threading.Barrier(threads)

    def work():
        start.wait()
        for i in range(each // 2):
            with profiling.span("outer", request=i):
                with profiling.span("inner"):
                    pass

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in pool)
    spans = profiling.recorded()
    # no span lost or counted twice, and the bound held exactly
    assert len(spans) == threads * each // 2 and profiling.dropped() == threads * each // 2
    for name, _, _, parent, request, thread in spans:
        if name == "inner" and parent is not None:
            assert spans[parent][0] == "outer" and spans[parent][4] == request
            assert spans[parent][5] == thread


def test_trace_writes_the_spans_beside_the_trace(tmp_path):
    import json

    with profiling.recording():
        with profiling.span("before"):
            pass
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.span("outer", request=5):
            with profiling.span("inner"):
                torch.ones(3).sum()
    assert (tmp_path / "tr" / "trace.json").exists()
    got = json.loads((tmp_path / "tr" / "spans.json").read_text())
    assert got["clock"] == "time.time_ns" and got["dropped"] == 0
    assert [(s["name"], s["parent"], s["request"]) for s in got["spans"]] == [
        ("outer", None, 5), ("inner", 0, 5)]
    assert got["spans"][0]["start_ns"] <= got["spans"][1]["start_ns"]


def test_serve_emits_its_spans_and_is_bit_equal_with_recording_on():
    items = _items(5)
    off = _pipe(max_in_flight=2)
    want = list(off.serve(items))
    on = _pipe(max_in_flight=2)
    with profiling.recording():
        got = list(on.serve(items))
    for a, b in zip(want, got):
        assert torch.equal(a.outputs, b.outputs) and a.n_events == b.n_events
    for a, b in zip(off.state, on.state):
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    spans = profiling.recorded()
    names = {s[0] for s in spans}
    assert names == {"serve.admit", "serve.pack", "serve.dispatch", "serve.upload",
                     "serve.unpack", "scan.integrate", "scan.conv_stack", "serve.post",
                     "serve.release", "host.sync", "conv.gemm", "conv.leaky", *FUSED_LAYERS}
    for name in ("serve.admit", "serve.dispatch", "scan.conv_stack", "serve.post"):
        assert [s[4] for s in _by_name(spans, name)] == [0, 1, 2, 3, 4]
    parent = {"serve.pack": "serve.admit", "serve.upload": "serve.dispatch",
              "serve.unpack": "serve.dispatch", "scan.integrate": "serve.dispatch",
              "scan.conv_stack": "serve.dispatch", "serve.post": "serve.dispatch",
              "host.sync": "serve.release", "conv.gemm": "layer.conv", "conv.leaky": "layer.conv"}
    parent.update({name: "scan.conv_stack" for name in FUSED_LAYERS})
    for name, t0, t1, up, request, _ in spans:
        assert t0 <= t1
        assert up is not None or name in ("serve.admit", "serve.dispatch", "serve.release")
        if up is not None:
            assert spans[up][0].startswith(parent[name]) and spans[up][4] == request
    # max_in_flight 2: each release retires one dispatch, named by its number
    assert [s[4] for s in _by_name(spans, "serve.release")] == [0, 1, 2, 3, 4]


def test_step_emits_its_spans_and_is_bit_equal_with_recording_on():
    chunks = _chunks(6)
    outs = {}
    for recording in (False, True):
        m = _model()
        st = m.init_state()
        grids = []
        with profiling.recording() if recording else contextlib.nullcontext():
            for c in chunks:
                st, grid = m.step(st, c)
                grids.append(grid)
        outs[recording] = (grids, st)
    for a, b in zip(outs[False][0], outs[True][0]):
        assert torch.equal(a, b)
    for a, b in zip(outs[False][1], outs[True][1]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    spans = profiling.recorded()
    assert [s[4] for s in _by_name(spans, "step")] == list(range(6))
    names = {s[0] for s in spans}
    assert {"step", "layer.intgr", "conv.sites", "host.sync", "conv.k3", "conv.dense",
            "conv.gemm", *LAYERS} <= names
    for name, _, _, up, request, _ in spans:
        if name != "step":
            assert up is not None and request == spans[up][4]
        if name == "host.sync":
            assert spans[up][0] == "conv.sites"
        if name in ("conv.sites", "conv.k3", "conv.dense"):
            assert spans[up][0].startswith("layer.conv")


@pytest.mark.parametrize("mode", ["sparse_pallas", "window"])
def test_each_host_read_of_a_step_has_its_host_sync_span(mode):
    m = _model(mode)
    st = m.init_state()
    syncs = []
    with profiling.recording():
        for c in _chunks(5, seed=3, events=CAP // 2):
            before = sum(n["host_syncs"] for n in m.net.layer_counts.values())
            st, _ = m.step(st, c)
            syncs.append(sum(n["host_syncs"] for n in m.net.layer_counts.values()) - before)
    spans = profiling.recorded()
    steps = [s[4] for s in _by_name(spans, "step")]
    got = [sum(1 for s in _by_name(spans, "host.sync") if s[4] == k) for k in steps]
    assert got == syncs and all(n > 0 for n in syncs)


def test_serve_from_a_threaded_source_records_each_thread_apart():
    items = _items(4, seed=2)
    pipe = _pipe(max_in_flight=2)
    with profiling.recording():
        got = list(pipe.serve(serving.threaded_source(
            lambda: iter(range(4)), fn=lambda i: pipe.pack(items[i]), threads=2)))
    assert len(got) == 4
    spans = profiling.recorded()
    packs = _by_name(spans, "serve.pack")
    main = threading.get_ident()
    # on the workers' threads, where no span encloses them
    assert len(packs) == 4 and all(s[3] is None and s[5] != main for s in packs)
    for name in ("serve.admit", "serve.dispatch", "serve.release"):
        assert all(s[5] == main for s in _by_name(spans, name))


def test_latency_stats_are_stamped_at_completion():
    items = _items(12, seed=4)
    pipe = _pipe(max_in_flight=4)
    taken, given = {}, {}

    def source():
        for k, ev in enumerate(items):
            taken[k] = time.time()  # before the pipeline stamps the arrival
            yield ev

    for k, _ in enumerate(pipe.serve(source())):
        given[k] = time.time()  # after the watermark stamp of the old engine
    stats = pipe.latency_stats()
    assert list(stats) == ["n", "dispatch_latency_ms", "event_age_ms"] and stats["n"] == 12
    for q in (stats["dispatch_latency_ms"], stats["event_age_ms"]):
        assert list(q) == ["p50", "p95", "p99", "max"]
        assert 0 <= q["p50"] <= q["p95"] <= q["p99"] <= q["max"]
    assert stats["dispatch_latency_ms"]["max"] <= stats["event_age_ms"]["max"]
    # each stamp is no later than the watermark fetch that proved the
    # dispatch retired: no age exceeds the most the old stamp could read
    watermark_ages = [1e3 * (given[k] - taken[k]) for k in taken]
    assert stats["event_age_ms"]["max"] <= max(watermark_ages) + 1e-3
    assert stats["event_age_ms"]["p50"] <= float(np.median(watermark_ages)) + 1e-3


# ---- the benchmark's readers of the program's spans ----------------------

def _reader(name):
    from pathlib import Path

    from portbench.run import load

    return load(Path(__file__).resolve().parents[1], "metrics", name)


def _record(program, source=(), device=(), requests=10, trace_from=4):
    from portbench.harness import Record, Request
    from portbench.tracing import SOURCE_RANGE, WINDOW_RANGE, TraceEvents

    rec = Record(seconds=1.0, t_start=0.0)
    rec.requests = [Request(0.0, 200, 1) for _ in range(requests)]
    rec.trace_from = trace_from
    spans = [(WINDOW_RANGE, 1000, 2000)] + [(SOURCE_RANGE, s, e) for s, e in source]
    rec.trace = TraceEvents(spans, [("cudaLaunchKernel", 1500, 1501)], list(device))
    return rec, program


@pytest.fixture
def program(monkeypatch):
    """Hand the readers a fixed list of program spans."""
    box = []
    monkeypatch.setattr(profiling, "recorded", lambda: list(box))
    return box


def _span(name, t0, t1, request=None, parent=None):
    return (name, t0, t1, parent, request, 1)


def test_the_replay_readers_take_device_time_a_dispatch(program):
    program += [
        _span("serve.dispatch", 1000, 1400, 0), _span("layer.conv1", 1010, 1100, 0, 0),
        _span("conv.gemm", 1010, 1050, 0, 1), _span("conv.bias", 1050, 1060, 0, 1),
        _span("conv.leaky", 1060, 1100, 0, 1), _span("layer.pool1", 1100, 1150, 0, 0),
        _span("pool.max", 1100, 1150, 0, 5), _span("layer.conv2", 1150, 1300, 0, 0),
        _span("conv.bias", 1200, 1210, 0, 7),
        _span("serve.dispatch", 1500, 1900, 1), _span("layer.conv1", 1510, 1600, 1, 9),
        _span("conv.gemm", 1510, 1550, 1, 10),
        _span("serve.dispatch", 100, 200, 9),  # before the window: not read
    ]
    device = [("gemm", 1100, 1400, 1020), ("bias", 1400, 1410, 1055),
              ("leaky", 1410, 1420, 1070), ("pool", 1420, 1440, 1120),
              ("gemm2", 1440, 1500, 1160), ("bias2", 1500, 1502, 1205),
              ("gemm", 1600, 1900, 1520), ("unmatched", 1950, 1960, None)]
    rec, _ = _record(program, device=device)
    # dispatch 0: conv1 300 + 10 + 10, pool1 20; dispatch 1: conv1 300
    assert _reader("stem_ms.replay").read(rec) == pytest.approx((340 + 300) / 2 / 1e6)
    # bias 10 + 2, leaky 10, pool 20
    assert _reader("epilogue_ms.replay").read(rec) == pytest.approx(42 / 2 / 1e6)


def test_the_fused_pool_reader_takes_c1s_device_time_a_dispatch(program):
    program += [
        _span("serve.dispatch", 1000, 1400, 0), _span("layer.conv2", 1010, 1100, 0, 0),
        _span("conv.fused_pool", 1010, 1100, 0, 1), _span("layer.conv3", 1100, 1200, 0, 0),
        _span("conv.fused_pool", 1100, 1200, 0, 3), _span("layer.conv6", 1200, 1300, 0, 0),
        _span("conv.leaky", 1250, 1300, 0, 5),
        _span("serve.dispatch", 1500, 1900, 1), _span("conv.fused_pool", 1510, 1600, 1, 7),
    ]
    device = [("c1", 1100, 1300, 1020), ("c1", 1300, 1400, 1150), ("e1", 1400, 1410, 1260),
              ("c1", 1600, 1700, 1520)]
    rec, _ = _record(program, device=device)
    assert _reader("fused_pool_ms.replay").read(rec) == pytest.approx((300 + 100) / 2 / 1e6)
    # a program without C1 records no such span: nothing to read, no 0
    program[:] = [s for s in program if s[0] != "conv.fused_pool"]
    assert _reader("fused_pool_ms.replay").read(rec) is None


def test_the_live_readers_take_the_median_host_time_a_dispatch(program):
    for k, (admit, launch) in enumerate([(10, 100), (30, 300), (20, 200)]):
        t = 1000 + 300 * k
        program += [_span("serve.admit", t, t + admit, k),
                    _span("serve.pack", t, t + admit // 2, k, 0),
                    _span("serve.dispatch", t + 50, t + 50 + launch, k)]
    rec, _ = _record(program, device=[("k", 1100, 1200, 1060)])
    assert _reader("pack_ms_per_dispatch.live").read(rec) == pytest.approx(20 / 1e6)
    assert _reader("launch_ms_per_dispatch.live").read(rec) == pytest.approx(200 / 1e6)


def test_the_sync_readers_count_a_chunk(program):
    program += [_span("host.sync", 1000 + 10 * i, 1005 + 10 * i, i // 4) for i in range(24)]
    program += [_span("host.sync", 10, 20, 0)]  # before the window
    rec, _ = _record(program, device=[("k", 1100, 1200, 1060)], requests=10, trace_from=4)
    for cell in ("async", "clustered"):
        assert _reader(f"host_syncs_per_chunk.{cell}").read(rec) == pytest.approx(24 / 6)


def test_the_idle_readers_name_the_gaps(program):
    # busy [1100, 1200] and [1500, 1600]; idle 1000-1100 (source open),
    # 1200-1500 (step open at 1200), 1600-2000 (nothing open)
    program += [_span("step", 1150, 1250, 0), _span("host.sync", 1150, 1200, 0, 0)]
    device = [("k", 1100, 1200, 1050), ("k", 1500, 1600, 1450)]
    rec, _ = _record(program, source=[(990, 1120)], device=device)
    for cell in ("live", "async", "clustered"):
        assert _reader(f"idle_unnamed_share.{cell}").read(rec) == pytest.approx(
            100.0 * 400 / 800)


def test_the_readers_read_nothing_without_the_recorder_or_the_card(program, monkeypatch):
    program.append(_span("serve.dispatch", 1000, 1400, 0))
    names = ["stem_ms.replay", "epilogue_ms.replay", "fused_pool_ms.replay",
             "pack_ms_per_dispatch.live",
             "launch_ms_per_dispatch.live", "host_syncs_per_chunk.async",
             "idle_unnamed_share.live"]
    rec, _ = _record(program, device=[])  # a CPU trace: no device records
    assert all(_reader(n).read(rec) is None for n in names)
    monkeypatch.delattr(profiling, "recorded")  # a program without the recorder
    rec, _ = _record(program, device=[("k", 1100, 1200, 1050)])
    assert all(_reader(n).read(rec) is None for n in names)
