"""The port's serving stack (async_ev_cnn_torch/utils/{wire,runner,serving}.py,
models/{yolo,head}.py) held against the JAX package on the same items.

Tolerances: the wire round trip, packing, ``prev_ts`` and epochs are
exact.  Network outputs agree to 1e-4 absolute (float32 convs).  Final
surfaces agree to 1e-6: on the CPU the JAX pipeline and ``YoloEventJax.scan``
take the max-plus 'xla' integrate engine, ~1 ulp from exact
(async_ev_cnn_tpu/ops/integrate.py); the bit-exact surface checks against
the event-scatter engine are in test_torch_network.py.  Comparisons of the
port with itself are bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from async_ev_cnn_torch.layers.network import EventNetwork as TNet
from async_ev_cnn_torch.models import head as thead
from async_ev_cnn_torch.models.yolo import YoloEventTorch
from async_ev_cnn_torch.utils import serving as tserving
from async_ev_cnn_torch.utils.config import layers_dict
from async_ev_cnn_torch.utils.runner import pack_chunks as t_pack_chunks
from async_ev_cnn_torch.utils.weights import params_from_jax
from async_ev_cnn_torch.utils.wire import chunks_from_wire as t_unwire
from async_ev_cnn_torch.utils.wire import pack_wire as t_pack_wire
from async_ev_cnn_tpu.layers.network import EventNetwork as JNet
from async_ev_cnn_tpu.models import head as jhead
from async_ev_cnn_tpu.models.yolo import YoloEventJax
from async_ev_cnn_tpu.utils import serving as jserving
from async_ev_cnn_tpu.utils.runner import pack_chunks as j_pack_chunks
from async_ev_cnn_tpu.utils.wire import chunks_from_wire as j_unwire
from async_ev_cnn_tpu.utils.wire import pack_wire as j_pack_wire

torch.set_num_threads(2)

H = W = 16
CAP = 32
DSL = "conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,8 pool2=2,2 conv3=1,1,8,12"
OUT_TOL = 1e-4
SURF_TOL = 1e-6


def _params(dsl, rng):
    out = {}
    for name, size in layers_dict(dsl).items():
        if "conv" in name:
            out[f"w_{name}"] = (rng.randn(*size[:2], size[2], size[3]) * 0.1).astype(np.float32)
            out[f"b_{name}"] = (rng.randn(size[3]) * 0.1).astype(np.float32)
    return out


def _nets(dsl=DSL, leak=1e-4):
    kw = dict(leak=leak, alpha=0.1, padding="SAME", conv_mode="full")
    return TNet(layers_dict(dsl), H, W, **kw), JNet(layers_dict(dsl), H, W, **kw)


def _stream(rng, n, polarity=False):
    cols = [rng.randint(0, H, n), rng.randint(0, W, n),
            np.cumsum(rng.randint(1, 20, n))]
    if polarity:
        cols.append(rng.randint(0, 2, n))
    return np.stack(cols, axis=-1).astype(np.int32)


def _contiguous(items):
    t0 = 0
    for ev in items:
        ev[:, 2] += t0
        t0 = int(ev[-1, 2]) + 1
    return items


def _pipes(rng, dsl=DSL, leak=1e-4, wire="plain", **kw):
    tn, jn = _nets(dsl, leak)
    params = _params(dsl, rng)
    t = tserving.StreamingPipeline(tn, params_from_jax(params, "cpu"), capacity=CAP,
                                   wire=wire, device="cpu", **kw)
    j = jserving.StreamingPipeline(jn, params, capacity=CAP, wire=wire, **kw)
    return t, j


def _rebasing_items(rng, n_items=5):
    """A stream whose relative clock crosses 2**30 µs inside int32."""
    items, t0 = [], 0
    lo, hi = int(0.2 * 2**30 / CAP), int(0.42 * 2**30 / CAP)
    for _ in range(n_items):
        ts = t0 + np.cumsum(rng.randint(lo, hi, CAP).astype(np.int64))
        t0 = int(ts[-1]) + 1
        items.append(np.stack([rng.randint(0, H, CAP), rng.randint(0, W, CAP), ts],
                              axis=-1).astype(np.int64))
    assert 2**30 < items[-1][-1, 2] < 2**31 - 1
    return items


@pytest.mark.parametrize("polarity", [False, True])
def test_wire_round_trip_matches_jax(rng, polarity):
    ev = _stream(rng, 3 * CAP + 5, polarity)
    ev[:4, 0] = [0, 2**15 - 1, 7, 2**15 - 2]  # the top y bits
    tw = t_pack_wire(ev, CAP, keep_polarity=polarity)
    jw = j_pack_wire(ev, CAP, keep_polarity=polarity)
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a, b)
    got = t_unwire(*(torch.from_numpy(a) for a in tw), polarity=polarity)
    want = j_unwire(*jw, polarity=polarity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # and equal to packing the raw events into chunks directly
    direct = t_pack_chunks(ev if polarity else ev[:, :3], CAP, device="cpu")
    jdirect = j_pack_chunks(ev if polarity else ev[:, :3], CAP)
    for g, d, jd in zip(got, direct, jdirect):
        np.testing.assert_array_equal(g.numpy(), d.numpy())
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    with pytest.raises(ValueError, match="polarity must be 0/1"):
        bad = _stream(rng, 4, True)
        bad[0, 3] = -1
        t_pack_wire(bad, CAP, keep_polarity=True)


@pytest.mark.parametrize("max_in_flight", [1, 3])
def test_pipeline_matches_jax_including_rebase(rng, max_in_flight):
    """Six contiguous items, then a stream whose clock passes 2**30 µs
    (rebase), through both pipelines: outputs, surfaces, prev_ts, epochs
    and the event counts."""
    t_pipe, j_pipe = _pipes(rng, max_in_flight=max_in_flight, t_chunks=3)
    items = _contiguous([_stream(rng, 2 * CAP + (i % 3) * 7) for i in range(6)])
    items += [ev + np.array([0, 0, int(items[-1][-1, 2]) + 1]) for ev in _rebasing_items(rng)]
    got = list(t_pipe.serve(items))
    want = list(j_pipe.serve(items))
    assert t_pipe._epochs == j_pipe._epochs and t_pipe._epochs[0] > 0
    assert len(got) == len(want) == len(items)
    for g, w in zip(got, want):
        assert g.n_events == w.n_events
        np.testing.assert_array_equal(g.counts, w.counts)
        np.testing.assert_allclose(g.outputs.numpy(), np.asarray(w.outputs),
                                   rtol=0, atol=OUT_TOL)
    np.testing.assert_allclose(t_pipe.state[0].surface.numpy(),
                               np.asarray(j_pipe.state[0].surface), rtol=0, atol=SURF_TOL)
    assert int(t_pipe.state[0].prev_ts) == int(j_pipe.state[0].prev_ts)
    assert t_pipe.stats == j_pipe.stats


def test_pipeline_prepared_items_and_polarity_match_jax(rng):
    """prepare() items on a 2-channel (keep_polarity) net, rebasing."""
    dsl = "conv1=3,3,2,4 pool1=2,2 conv2=1,1,4,6"
    t_pipe, j_pipe = _pipes(rng, dsl, keep_polarity=True)
    items = _rebasing_items(rng, 4)
    for ev in items:
        ev[:, 0] %= H
    items = [np.concatenate([ev, rng.randint(0, 2, (len(ev), 1))], axis=1) for ev in items]
    got = list(t_pipe.serve([t_pipe.prepare(ev) for ev in items]))
    want = list(j_pipe.serve([j_pipe.prepare(ev) for ev in items]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.outputs.numpy(), np.asarray(w.outputs),
                                   rtol=0, atol=OUT_TOL)
    np.testing.assert_allclose(t_pipe.state[0].surface.numpy(),
                               np.asarray(j_pipe.state[0].surface), rtol=0, atol=SURF_TOL)
    assert int(t_pipe.state[0].prev_ts) == int(j_pipe.state[0].prev_ts)
    assert t_pipe._epochs == j_pipe._epochs and t_pipe._epochs[0] > 0


def test_yolo_scan_and_decode_match_jax(rng):
    """YoloEventTorch.scan against YoloEventJax.scan on the same chunks and
    weights, then head.decode on one grid and on the batch of grids."""
    kw = dict(h_frame=H, w_frame=W, num_classes=2, cnn_layers=layers_dict(DSL),
              cnn_padding="SAME", h_cells=4, w_cells=4, num_bbox=2, alpha=0.1,
              leak=1e-4, conv_mode="auto")
    tm = YoloEventTorch(**kw, device="cpu")
    jm = YoloEventJax(**kw)
    params = _params(DSL, rng)
    tm.set_weights(params)
    jm.set_weights(params)
    ev = _stream(rng, 5 * CAP)
    t_st, t_out = tm.scan(tm.init_state(), t_pack_chunks(ev, CAP, device="cpu"))
    j_st, j_out = jm.scan(jm.init_state(), j_pack_chunks(ev, CAP))
    assert tuple(t_out.shape) == j_out.shape == (5, *tm.grid_shape)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0, atol=OUT_TOL)
    np.testing.assert_allclose(t_st[0].surface.numpy(), np.asarray(j_st[0].surface),
                               rtol=0, atol=SURF_TOL)
    assert int(t_st[0].prev_ts) == int(j_st[0].prev_ts)

    grids = rng.rand(3, 4, 5, 2 + 2 * 5).astype(np.float32)
    batched = thead.decode(torch.from_numpy(grids), 2, 2, 40, 56)
    for i in range(3):
        one = thead.decode(torch.from_numpy(grids[i]), 2, 2, 40, 56)
        want = jhead.decode(jnp.asarray(grids[i]), 2, 2, 40, 56)
        for g, b, w in zip(one, batched, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(b[i].numpy(), np.asarray(w))
    for sqrt in (True, False):
        box = rng.rand(2, 4, 5, 2, 4).astype(np.float32)
        np.testing.assert_array_equal(
            thead.convert_bboxes(torch.from_numpy(box), 4, 5, 40, 56, sqrt).numpy(),
            np.asarray(jhead.convert_bboxes(box, 4, 5, 40, 56, sqrt)))


def test_f1_raw_item_carries_pending_shift_of_dropped_prepared_items(rng):
    """F1 (fixed in the port).  Item 1 is prepare()d — advancing the epoch
    by its rebase — and then dropped; item 2 arrives as a raw array.  The
    port applies the pending shift of the dropped item together with item
    2's own, so it equals a raw-array pipeline that never saw item 1.  The
    JAX engine (utils/serving.py, raw-array path) marks the ledger applied
    without the pending shift, so its device clock lags the host epoch and
    its output differs."""
    B = 2**30
    items = []
    for start in (0, B, B + B // 4):  # item 1 rebases; item 2 does not again
        ts = start + np.cumsum(rng.randint(1, B // (8 * CAP), CAP)).astype(np.int64)
        items.append(np.stack([rng.randint(0, H, CAP), rng.randint(0, W, CAP), ts],
                              axis=-1).astype(np.int64))
    leak = 2e-9  # the clock gap between the items matters at this leak
    t_pipe, j_pipe = _pipes(rng, leak=leak)
    p0 = t_pipe.prepare(items[0])
    t_pipe.prepare(items[1])  # dropped before dispatch
    got = [r.outputs for r in t_pipe.serve([p0, items[2]])]
    assert t_pipe._applied_epochs == t_pipe._epochs and t_pipe._epochs[0] > 0

    oracle, _ = _pipes(np.random.RandomState(0), leak=leak)
    oracle._params = t_pipe._params
    oracle._state = oracle._net.init_state(oracle._params, "cpu")
    want = [r.outputs for r in oracle.serve([items[0], items[2]])]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())

    jp0 = j_pipe.prepare(items[0])
    j_pipe.prepare(items[1])
    j_got = [np.asarray(r.outputs) for r in j_pipe.serve([jp0, items[2]])]
    assert np.abs(j_got[1] - want[1].numpy()).max() > 1e-3  # the JAX fault


def test_f2_verbatim_shift_mixed_with_ledger_raises(rng):
    """F2 (fixed in the port).  A hand-built PreparedItem (epoch=None) whose
    deltas carry a prev_ts shift, on a stream that also rebases through
    prepare() or raw arrays, would shift prev_ts twice (the JAX engine
    applies the verbatim deltas and later re-derives the same shift from
    its stale ledger).  The port raises on the mix, in either order; an
    epoch=None item without a shift stays allowed."""
    t_pipe, _ = _pipes(rng)
    far = _stream(rng, CAP).astype(np.int64)
    far[:, 2] += 2**30
    prepared = t_pipe.prepare(far)
    assert prepared.epoch > 0 and prepared.deltas.any()
    list(t_pipe.serve([tserving.PreparedItem(prepared.wire, np.zeros(2, np.int32))]))
    with pytest.raises(ValueError, match="mixes hand-built"):
        list(t_pipe.serve([tserving.PreparedItem(prepared.wire, prepared.deltas)]))

    t_pipe2, _ = _pipes(rng)
    list(t_pipe2.serve([tserving.PreparedItem(t_pipe2.pack(_stream(rng, CAP)),
                                              np.array([5, 5], np.int32))]))
    with pytest.raises(ValueError, match="mixes hand-built"):
        t_pipe2.prepare(far)
    with pytest.raises(ValueError, match="mixes hand-built"):
        list(t_pipe2.serve([far]))


@pytest.mark.parametrize("fault", ["slot", "regressed", "prepacked"])
def test_f3_completed_dispatches_are_yielded_before_an_admission_error(rng, fault):
    """F3 (fixed in the port).  On a slot mismatch, an epoch regression or a
    pre-packed item on a rebased stream, the JAX engine raises with the
    dispatches already in flight never yielded; the port yields them, in
    order and equal to a clean run, and then raises."""
    t_pipe, _ = _pipes(rng, max_in_flight=16)
    ev1 = _stream(rng, CAP).astype(np.int64)
    ev1[:, 2] += 2**30
    ev2 = _stream(rng, CAP).astype(np.int64)
    ev2[:, 2] += 2**31
    good = [t_pipe.prepare(ev1), t_pipe.prepare(ev2)]
    bad = {"slot": good[1]._replace(stream=1),
           "regressed": good[0],
           "prepacked": t_pipe.pack(_stream(rng, CAP))}[fault]
    got = []
    with pytest.raises(ValueError):
        for r in t_pipe.serve(good + [bad]):
            got.append(r)
    assert len(got) == 2
    clean, _ = _pipes(np.random.RandomState(0))
    clean._params = t_pipe._params
    clean._state = clean._net.init_state(clean._params, "cpu")
    want = list(clean.serve([ev1, ev2]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.outputs.numpy(), w.outputs.numpy())
    assert t_pipe.latency_stats()["n"] == 2


def test_pipeline_bookkeeping(rng):
    """Padding chunks marked in counts, latency stats, oversize items,
    state install, postprocess on the outputs, the threaded source."""
    t_pipe, _ = _pipes(rng, t_chunks=4, postprocess=lambda o: o.sum(dim=-1))
    assert t_pipe.latency_stats() == {"n": 0}
    got = list(t_pipe.serve(tserving.threaded_source(
        lambda: iter(range(3)), fn=lambda i: _stream(np.random.RandomState(i), 2 * CAP))))
    assert len(got) == 3
    np.testing.assert_array_equal(got[0].counts, [CAP, CAP, 0, 0])
    assert tuple(got[0].outputs.shape) == (4, 4, 4)
    stats = t_pipe.latency_stats()
    assert stats["n"] == 3
    for q in (stats["dispatch_latency_ms"], stats["event_age_ms"]):
        assert 0 <= q["p50"] <= q["p95"] <= q["p99"] <= q["max"]
    with pytest.raises(ValueError, match="t_chunks=4"):
        t_pipe.pack(_stream(rng, 5 * CAP))

    saved = tuple(type(s)(*(f.numpy().copy() for f in s)) for s in t_pipe.state)
    t_pipe.state = saved
    assert all(isinstance(f, torch.Tensor) for s in t_pipe.state for f in s)
    with pytest.raises(ValueError, match="structure"):
        t_pipe.state = saved[:-1]

    def boom(_):
        raise OSError("decode failed")

    with pytest.raises(OSError, match="decode failed"):
        list(tserving.threaded_source(lambda: iter(range(4)), fn=boom))


def test_pipeline_slice_limits(rng, tmp_path):
    """The JAX engine's options: every wire tier, streams > 1 and a mesh are
    taken ('auto' is the default, as there), and bad values raise as there
    (a mesh with fewer than 2 streams among them; tests/
    test_torch_parallel_serving.py serves on a 2 x 2 mesh)."""
    from async_ev_cnn_torch.parallel import make_mesh, world

    tn, _ = _nets()
    params = params_from_jax(_params(DSL, rng), "cpu")
    for kw in (dict(), dict(wire="ultra4"), dict(wire="ultra"), dict(wire="compact"),
               dict(wire="plain"), dict(streams=2), dict(streams=3, wire="auto")):
        pipe = tserving.StreamingPipeline(tn, params, device="cpu", **kw)
        assert pipe._wire == kw.get("wire", "auto")
        streams = kw.get("streams", 1)
        assert pipe.state[0].surface.shape == ((streams,) if streams > 1 else ()) + (1, H, W)
    for kw, exc, match in ((dict(wire="gzip"), ValueError, "wire must be"),
                           (dict(streams=0), ValueError, "streams"),
                           (dict(max_in_flight=0), ValueError, "max_in_flight"),
                           (dict(keep_polarity=True), ValueError, "2-channel")):
        with pytest.raises(exc, match=match):
            tserving.StreamingPipeline(tn, params, device="cpu", **kw)
    with world("cpu"):
        mesh = make_mesh(1, 1, device="cpu")
        with pytest.raises(ValueError, match="mesh serving needs streams"):
            tserving.StreamingPipeline(tn, params, mesh=mesh)
        pipe = tserving.StreamingPipeline(tn, params, streams=2, mesh=mesh)
        assert pipe.device.type == "cpu" and pipe.state[0].surface.shape == (2, 1, H, W)
    model_kw = dict(h_frame=H, w_frame=W, num_classes=2, cnn_layers=layers_dict(DSL),
                    cnn_padding="SAME", h_cells=4, w_cells=4, num_bbox=2, alpha=0.1,
                    leak=1e-4, device="cpu")
    # the model takes checkpoints and ts_window: a missing checkpoint fails
    # loudly, a window below 1 is refused, a valid one is taken
    missing = str(tmp_path / "missing.npz")
    for kw, exc, match in ((dict(checkpoint=missing), FileNotFoundError, "missing.npz"),
                           (dict(ts_window=0), ValueError, "ts_window")):
        with pytest.raises(exc, match=match):
            YoloEventTorch(**model_kw, **kw)
    assert YoloEventTorch(**model_kw, ts_window=8)._ts_window == (8, 8)
    # an incremental model's scan takes the sequential engine
    m = YoloEventTorch(**model_kw, conv_mode="dense")
    m.set_weights(_params(DSL, rng))
    _, grids = m.scan(m.init_state(), t_pack_chunks(_stream(rng, CAP), CAP, device="cpu"))
    assert tuple(grids.shape[1:]) == m.grid_shape
