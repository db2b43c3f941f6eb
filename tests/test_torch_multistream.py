"""Multi-stream serving in the port held against the JAX package's ``vmap``:
the stream axis of the integration front half and of K1's plain version
(async_ev_cnn_torch/ops/{integrate,surface_scan}.py), the batched
parallel-in-time network (EventNetwork.scan_parallel on [S, T, E]) and the
multi-stream, multi-tier StreamingPipeline (utils/serving.py).

Tolerances:

* The front half and K1's plain version are bit for bit: every stream of
  ``chunk_event_updates`` and ``integrate_parallel`` on ``[S, T, E]``
  equals ``jax.vmap`` of the JAX functions (the JAX event-scatter kernel in
  interpret mode, as tests/test_pallas_scan.py runs it), and the stream
  axis equals S one-stream calls.
* Network outputs agree with the JAX package to 1e-5 absolute (float32
  convs of a 3-layer net of widths <= 12 summed in another order).
* The pipelines' final surfaces agree with the JAX package's to 1e-6: on
  the CPU the JAX pipeline takes the max-plus 'xla' integrate engine, ~1
  ulp from the exact chain, where the port takes the exact 'events'
  engine (the bit-exact comparisons are above).  ``prev_ts``, the epochs,
  the applied epochs, the counts and ``stats`` are exact.
* The port against itself (S streams in one pipeline against S one-stream
  pipelines) is held to 1e-6 on outputs (the conv stack batched over S*T
  frames instead of T) and bit for bit on the surfaces.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from async_ev_cnn_torch.layers.network import EventNetwork as TNet
from async_ev_cnn_torch.layers.types import EventChunk as TChunk
from async_ev_cnn_torch.ops import integrate as tint
from async_ev_cnn_torch.ops import surface_scan as tscan
from async_ev_cnn_torch.utils import serving as tserving
from async_ev_cnn_torch.utils.config import layers_dict
from async_ev_cnn_torch.utils.weights import params_from_jax
from async_ev_cnn_tpu.layers.network import EventNetwork as JNet
from async_ev_cnn_tpu.layers.types import EventChunk as JChunk
from async_ev_cnn_tpu.ops import integrate as jint
from async_ev_cnn_tpu.utils import serving as jserving

torch.set_num_threads(2)

H = W = 16
CAP = 32
S = 3
DSL = "conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,8 pool2=2,2 conv3=1,1,8,12"
OUT_TOL = 1e-5
SURF_TOL = 1e-6
SELF_TOL = 1e-6


def _assert_bits(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want)


def _stream_arrays(rng, s, t, e, h, w):
    ts = np.cumsum(rng.randint(1, 40, (s, t * e)), axis=1).astype(np.int32).reshape(s, t, e)
    y = rng.randint(0, h, (s, t, e)).astype(np.int32)
    x = rng.randint(0, w, (s, t, e)).astype(np.int32)
    p = rng.randint(0, 2, (s, t, e)).astype(np.int32)
    valid = rng.rand(s, t, e) < 0.8
    y[1, 2, 3] = y[1, 2, 1]  # a duplicate pixel with a ts tie in stream 1
    x[1, 2, 3] = x[1, 2, 1]
    ts[1, 2, 3] = ts[1, 2, 1]
    valid[2, 1] = False  # an all-padding chunk in stream 2
    return y, x, ts, p, valid


def _both(arrays):
    return (TChunk(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)),
            JChunk(*(jnp.asarray(a) for a in arrays)))


@pytest.mark.parametrize("channels", [1, 2])
def test_stream_axis_front_half_matches_jax_vmap(rng, channels):
    """_ts_chain, chunk_event_updates and integrate_parallel on [S, T, E]
    against jax.vmap of the JAX functions (integrate_parallel through the
    JAX event-scatter kernel, interpret mode), bit for bit; and each
    stream equal to a one-stream call of the port."""
    h, w, t, e, leak = 7, 9, 6, 10, 3e-3
    tc, jc = _both(_stream_arrays(rng, S, t, e, h, w))
    prev = np.array([0, 5, 40], np.int32)
    surf = (np.round(rng.rand(S, channels, h, w) * 2**20) / 2**20).astype(np.float32)

    lt, d = tint._ts_chain(torch.from_numpy(prev), tc, leak)
    ltj, dj = jax.vmap(lambda p, c: jint._ts_chain(p, c, leak))(jnp.asarray(prev), jc)
    _assert_bits(lt, ltj)
    _assert_bits(d, dj)

    pix, dt, d2, lt2 = tint.chunk_event_updates(channels, h, w, torch.from_numpy(prev), tc,
                                                leak)
    pr, pc, dtj, d2j, lt2j = jax.vmap(
        lambda p, c: jint.chunk_event_updates(channels, h, w, p, c, leak))(jnp.asarray(prev),
                                                                          jc)
    pr, pc = np.asarray(pr), np.asarray(pc)
    np.testing.assert_array_equal(pix.numpy(), np.where(pr >= 0, pr * 128 + pc, -1))
    for a, b in ((dt, dtj), (d2, d2j), (lt2, lt2j)):
        _assert_bits(a, b)

    got, got_lt = tint.integrate_parallel(torch.from_numpy(surf), torch.from_numpy(prev), tc,
                                          leak)
    want, want_lt = jax.vmap(lambda s, p, c: jint.integrate_parallel(
        s, p, c, leak, engine="pallas"))(jnp.asarray(surf), jnp.asarray(prev), jc)
    _assert_bits(got, want)
    _assert_bits(got_lt, want_lt)
    for engine in ("events", "tsmap", "maxplus"):
        batched, batched_lt = tint.integrate_parallel(
            torch.from_numpy(surf), torch.from_numpy(prev), tc, leak, engine=engine)
        for i in range(S):
            one, one_lt = tint.integrate_parallel(
                torch.from_numpy(surf[i]), int(prev[i]), TChunk(*(f[i] for f in tc)), leak,
                engine=engine)
            _assert_bits(batched[i], one)
            _assert_bits(batched_lt[i], one_lt)
        if engine != "maxplus":  # the exact engines
            _assert_bits(batched, want)


def test_stream_axis_plain_k1_equals_single_stream_calls(rng):
    """K1's plain version (and its wrapper, which runs it for CPU tensors)
    with a stream axis: each stream bit-equal to a call of its own; the
    plan's workspace counts every stream; shape errors are refused."""
    h, w, t, e, leak = 6, 11, 70, 9, 2e-3
    tc, _ = _both(_stream_arrays(rng, S, t, e, h, w))
    prev = torch.tensor([3, 0, 9], dtype=torch.int32)
    pix, dt, d, _ = tint.chunk_event_updates(2, h, w, prev, tc, leak)
    surf = torch.from_numpy((np.round(rng.rand(S, 2, h, w) * 2**20) / 2**20)
                            .astype(np.float32))
    batched = tscan.surface_scan_events(surf, pix, dt, d, leak)
    assert tuple(batched.shape) == (S, t, 2, h, w)
    for i in range(S):
        _assert_bits(batched[i], tscan.surface_scan_events_plain(surf[i], pix[i], dt[i], d[i],
                                                                 leak))
    one = tscan.scan_events_plan(t, e, 2 * h * w)
    plan = tscan.scan_events_plan(t, e, 2 * h * w, S)
    assert plan._replace(workspace=one.workspace) == one
    assert plan.workspace == S * one.workspace
    with pytest.raises(ValueError, match="streams"):
        tscan.scan_events_plan(t, e, 2 * h * w, 65536)


def _params(dsl, rng):
    out = {}
    for name, size in layers_dict(dsl).items():
        if "conv" in name:
            out[f"w_{name}"] = (rng.randn(*size[:2], size[2], size[3]) * 0.1).astype(np.float32)
            out[f"b_{name}"] = (rng.randn(size[3]) * 0.1).astype(np.float32)
    return out


def _nets(dsl=DSL, leak=1e-4, **kw):
    kw = dict(leak=leak, alpha=0.1, padding="SAME", conv_mode="full", **kw)
    return TNet(layers_dict(dsl), H, W, **kw), JNet(layers_dict(dsl), H, W, **kw)


@pytest.mark.parametrize("window", [None, 2])
def test_scan_parallel_streams_matches_jax_vmap(rng, window):
    """EventNetwork.scan_parallel on [S, T, E] chunks against jax.vmap of
    the JAX scan_parallel (its 'pallas' engine, interpret mode), with and without a
    time window that leaves a ragged last window; and each stream against
    the port's one-stream scan_parallel."""
    tn, jn = _nets()
    params = _params(DSL, rng)
    tp = params_from_jax(params, "cpu")
    t, e = 5, 12
    tc, jc = _both(_stream_arrays(rng, S, t, e, H, W))
    st0 = tn.init_state(tp, "cpu")
    tst = tuple(type(s)(*(f.expand(S, *f.shape).clone() for f in s)) for s in st0)
    jst = jax.tree.map(lambda a: jnp.broadcast_to(a, (S, *a.shape)), jn.init_state(params))
    new, outs = tn.scan_parallel(tp, tst, tc, window=window)
    jnew, jouts = jax.vmap(lambda s, c: jn.scan_parallel(
        params, s, c, window=window, integrate_engine="pallas"))(jst, jc)
    assert tuple(outs.shape) == jouts.shape
    np.testing.assert_allclose(outs.numpy(), np.asarray(jouts), rtol=0, atol=OUT_TOL)
    _assert_bits(new[0].surface, jnew[0].surface)
    _assert_bits(new[0].prev_ts, jnew[0].prev_ts)
    for i in range(S):
        one_st, one = tn.scan_parallel(tp, tuple(type(s)(*(f[i] for f in s)) for s in tst),
                                       TChunk(*(f[i] for f in tc)), window=window)
        np.testing.assert_allclose(outs[i].numpy(), one.numpy(), rtol=0, atol=SELF_TOL)
        _assert_bits(new[0].surface[i], one_st[0].surface)


def _items(rng, n, gap, t0=0):
    ts = t0 + np.cumsum(rng.randint(1, gap, n)).astype(np.int64)
    return np.stack([rng.randint(0, H, n), rng.randint(0, W, n), ts], axis=-1).astype(np.int64)


def _mixed_source(rng, rounds=4):
    """S streams of raw items, round-robin: stream 0 fits ultra4 (gaps <
    16 µs), stream 1 ultra at first and compact from round 2 (gaps of ~2
    ms), stream 2 crosses 2**30 µs in round 2 (a rebase), its spans plain
    there.  Every item is 2 chunks of events or fewer."""
    ends = [0] * S
    items = []
    for r in range(rounds):
        for s in range(S):
            n = 2 * CAP - 3 * s - r
            if s == 0:
                ev = _items(rng, n, 15, ends[s])
            elif s == 1:
                ev = _items(rng, n, 200 if r < 2 else 4000, ends[s])
            else:
                start = ends[s] + (2**30 if r == 2 else 0)
                ev = _items(rng, n, 50 if r != 2 else 90_000, start)
            ends[s] = int(ev[-1, 2]) + 1
            items.append(ev)
    return items


def _pipes(rng, streams=S, **kw):
    tn, jn = _nets()
    params = _params(DSL, rng)
    t = tserving.StreamingPipeline(tn, params_from_jax(params, "cpu"), capacity=CAP,
                                   streams=streams, device="cpu", **kw)
    j = jserving.StreamingPipeline(jn, params, capacity=CAP, streams=streams, **kw)
    return t, j


def _assert_pipes_agree(t_pipe, j_pipe, got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.n_events == w.n_events
        np.testing.assert_array_equal(g.counts, w.counts)
        np.testing.assert_allclose(g.outputs.numpy(), np.asarray(w.outputs), rtol=0,
                                   atol=OUT_TOL)
    np.testing.assert_allclose(t_pipe.state[0].surface.numpy(),
                               np.asarray(j_pipe.state[0].surface), rtol=0, atol=SURF_TOL)
    np.testing.assert_array_equal(t_pipe.state[0].prev_ts.numpy(),
                                  np.asarray(j_pipe.state[0].prev_ts))
    assert t_pipe._epochs == j_pipe._epochs
    assert t_pipe._applied_epochs == j_pipe._applied_epochs
    # the JAX engine's counters, and the port's own: every dispatch eager on the CPU
    assert t_pipe.stats == dict(j_pipe.stats, eager_dispatches=j_pipe.stats["dispatches"],
                                graph_replays=0, graph_captures=0)
    assert t_pipe._era == j_pipe._era


@pytest.mark.parametrize("prepared", [False, True])
def test_multistream_pipeline_matches_jax(rng, prepared):
    """streams=3, wire='auto', t_chunks=2: raw items (or prepare()d ones)
    whose groups mix tiers and whose stream 2 rebases across 2**30 µs;
    outputs, counts, surfaces, prev_ts, epochs, the tier era and stats
    against the JAX pipeline, and the tier climbs from ultra4 to plain."""
    t_pipe, j_pipe = _pipes(rng, t_chunks=2, max_in_flight=3)
    items = _mixed_source(rng)
    if prepared:
        t_src = [t_pipe.prepare(ev, stream=k % S) for k, ev in enumerate(items)]
        j_src = [j_pipe.prepare(ev, stream=k % S) for k, ev in enumerate(items)]
        for a, b in zip(t_src, j_src):
            for x, y in zip(a.wire, b.wire):
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
            assert (a.stream, a.epoch) == (b.stream, b.epoch)
            np.testing.assert_array_equal(a.deltas, b.deltas)
    else:
        t_src = j_src = items
    tiers = []
    got = []
    for r in t_pipe.serve(t_src):
        got.append(r)
        tiers.append(t_pipe.wire_tier)
    want = list(j_pipe.serve(j_src))
    _assert_pipes_agree(t_pipe, j_pipe, got, want)
    assert t_pipe._epochs[2] > 0 and t_pipe._epochs[:2] == [0, 0]
    assert t_pipe.wire_tier == "plain"
    assert tuple(got[0].outputs.shape[:2]) == (S, 2)


def test_multistream_pipeline_equals_single_stream_pipelines(rng):
    """The same three streams through one streams=3 pipeline and through
    three one-stream pipelines (pinned to the tier the group settles on):
    outputs within 1e-6, surfaces and prev_ts bit for bit."""
    t_pipe, _ = _pipes(rng, t_chunks=2)
    items = _mixed_source(rng)
    got = list(t_pipe.serve(items))
    tn, _ = _nets()
    singles = []
    for s in range(S):
        one = tserving.StreamingPipeline(tn, t_pipe._params, capacity=CAP, t_chunks=2,
                                         wire="auto", device="cpu")
        outs = [r.outputs for r in one.serve(items[s::S])]
        singles.append((one, outs))
    for s, (one, outs) in enumerate(singles):
        for k, o in enumerate(outs):
            np.testing.assert_allclose(got[k].outputs[s].numpy(), o.numpy(), rtol=0,
                                       atol=SELF_TOL)
        _assert_bits(t_pipe.state[0].surface[s], one.state[0].surface)
        assert int(t_pipe.state[0].prev_ts[s]) == int(one.state[0].prev_ts)
        assert one._epochs[0] == t_pipe._epochs[s]


def test_multistream_round_robin_and_admission_errors(rng):
    """A PreparedItem for the wrong slot raises in both packages; the port
    yields the dispatches already in flight first (F3).  Unequal chunk
    counts in a group raise; a ragged tail is dropped; stem_fusion='auto'
    is turned off for streams > 1 (as in the JAX engine), an explicit True
    kept."""
    t_pipe, j_pipe = _pipes(rng, t_chunks=2, max_in_flight=8)
    items = _mixed_source(rng, rounds=2)
    t_good = [t_pipe.prepare(ev, stream=k % S) for k, ev in enumerate(items)]
    j_good = [j_pipe.prepare(ev, stream=k % S) for k, ev in enumerate(items)]
    t_bad = t_good[:S] + [t_good[S + 1], t_good[S]] + t_good[S + 2:]
    j_bad = j_good[:S] + [j_good[S + 1], j_good[S]] + j_good[S + 2:]
    got = []
    with pytest.raises(ValueError, match="dispatch slot 0 received a PreparedItem for stream 1"):
        for r in t_pipe.serve(t_bad):
            got.append(r)
    assert len(got) == 1
    with pytest.raises(ValueError, match="out of round-robin order"):
        list(j_pipe.serve(j_bad))

    t_pipe, _ = _pipes(rng)
    ragged = [_items(rng, CAP, 10) for _ in range(S + 2)]
    assert len(list(t_pipe.serve(ragged))) == 1
    uneven = [_items(rng, CAP, 10), _items(rng, 3 * CAP, 10), _items(rng, CAP, 10)]
    with pytest.raises(ValueError, match="equally many chunks"):
        list(t_pipe.serve(uneven))

    for fusion, want in (("auto", False), (True, True)):
        tn, _ = _nets(stem_fusion=fusion)
        params = params_from_jax(_params(DSL, rng), "cpu")
        assert tserving.StreamingPipeline(tn, params, streams=2,
                                          device="cpu")._net._stem_fusion is want
        assert tserving.StreamingPipeline(tn, params, device="cpu")._net._stem_fusion is fusion


@pytest.mark.parametrize("wire", ["ultra4", "ultra", "compact", "plain"])
def test_pinned_tiers_match_jax(rng, wire):
    """Each pinned tier, one stream and two, against the JAX pipeline; a
    pinned tier refuses an item it cannot carry, as there."""
    for streams in (1, 2):
        t_pipe, j_pipe = _pipes(rng, streams=streams, wire=wire, t_chunks=3)
        items = [_items(rng, 2 * CAP + 5, 10) for _ in range(2 * streams)]
        _assert_pipes_agree(t_pipe, j_pipe, list(t_pipe.serve(items)),
                            list(j_pipe.serve(items)))
        assert t_pipe.wire_tier == wire
    if wire != "plain":
        t_pipe, j_pipe = _pipes(rng, wire=wire)
        wide = _items(rng, CAP, 100_000)
        for p in (t_pipe, j_pipe):
            with pytest.raises(ValueError, match=f"does not fit the {wire} wire"):
                p.pack(wide)
