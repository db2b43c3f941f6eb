"""The port's frame path and its oracles held against the JAX package:
``integrate_frame``/``integrate_frame_chunked`` (async_ev_cnn_torch/ops/
integrate.py), ``YoloFrameTorch`` and ``YoloFrameNumpy`` (models/yolo.py),
``AsyncEventNumpy`` (models/event_numpy_cpu.py), ``ts_window`` and the
'maxplus' integrate engine.

Tolerances: frame integration, the ts maps, the surfaces of every engine
and the copied numpy oracles bit for bit (float32 bit patterns); the
'maxplus' engine bit for bit against the JAX 'xla' engine (the same
grouping of the same float32 operations) and within 1e-6 of the port's
'events' engine (the JAX package's tolerance between its engines); float32
conv stacks within 1e-4 (tests/test_equivalence.py's contract).  The JAX
'pallas_tsmap' engine runs its kernel in interpret mode on the CPU.
"""

from collections import OrderedDict

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from async_ev_cnn_torch.layers import network as tnet
from async_ev_cnn_torch.layers.types import EventChunk as TChunk
from async_ev_cnn_torch.models import event_numpy_cpu as tcpu
from async_ev_cnn_torch.models import yolo as tyolo
from async_ev_cnn_torch.ops import integrate as tint
from async_ev_cnn_torch.utils.weights import params_from_jax
from async_ev_cnn_tpu.layers import network as jnet
from async_ev_cnn_tpu.layers.types import EventChunk as JChunk
from async_ev_cnn_tpu.models import event_numpy_cpu as jcpu
from async_ev_cnn_tpu.models import yolo as jyolo
from async_ev_cnn_tpu.ops import integrate as jint
from async_ev_cnn_tpu.utils.config import layers_dict

torch.set_num_threads(2)
TOL = 1e-4
ENGINE_TOL = 1e-6
DSL = "conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,8 pool2=2,2 conv3=1,1,8,12"
# the same with a dense tail: 4x4x8 featuremap -> 4x4x12 grid
TAIL_DSL = "conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,8 pool2=2,2 flatten1=0 fc1=128,192"


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bits(got, want):
    g, w = _bits(got), _bits(want)
    assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_array_equal(g, w)


def _events(rng, n, h, w, start=0, max_dt=30):
    ts = start + np.cumsum(rng.randint(0, max_dt, n))
    return np.stack([rng.randint(0, h, n), rng.randint(0, w, n), ts], -1).astype(np.int32)


def _model_args(dsl=DSL, num_classes=2, h=16, w=16):
    return dict(h_frame=h, w_frame=w, num_classes=num_classes, cnn_layers=layers_dict(dsl),
                cnn_padding="SAME", h_cells=4, w_cells=4, num_bbox=2, alpha=0.1, leak=0.01)


def _params(rng, dsl=DSL):
    params = {}
    for name, size in layers_dict(dsl).items():
        if "conv" in name:
            kh, kw, ci, co = size
            params[f"w_{name}"] = rng.randn(kh, kw, ci, co).astype(np.float32) * 0.3
            params[f"b_{name}"] = rng.randn(co).astype(np.float32) * 0.1
        elif "fc" in name:
            params[f"w_{name}"] = rng.randn(*size).astype(np.float32) * 0.1
            params[f"b_{name}"] = rng.randn(size[1]).astype(np.float32) * 0.1
    return params


# ---- frame integration ---------------------------------------------------------


def _frame_cases(rng):
    h, w = 12, 17
    yield "random", _events(rng, 60, h, w), None
    # every event on two pixels, with ts ties: the last duplicate wins
    dup = np.array([[3, 4, 7], [3, 4, 9], [1, 2, 9], [3, 4, 9], [1, 2, 12], [3, 4, 12]],
                   np.int32)
    yield "duplicates", dup, None
    # a large leak clamps most of the previous frame at zero
    prev = (np.round(np.random.RandomState(3).rand(h, w) * 2**20) / 2**20).astype(np.float32)
    yield "clamp", _events(rng, 30, h, w, start=5000), (prev, np.int32(10))
    yield "empty", np.zeros((0, 3), np.int32), (prev, np.int32(10))
    yield "empty_first", np.zeros((0, 3), np.int32), None


def test_integrate_frame_bit_exact(rng):
    for name, events, prev in _frame_cases(rng):
        jprev = None if prev is None else (jnp.asarray(prev[0]), jnp.asarray(prev[1]))
        tprev = None if prev is None else (torch.from_numpy(prev[0]), int(prev[1]))
        f_j, ts_j = jint.integrate_frame(events, 2e-3, 12, 17, jprev)
        f_t, ts_t = tint.integrate_frame(events, 2e-3, 12, 17, tprev, device="cpu")
        _assert_bits(f_t, f_j)
        assert ts_t.dtype == torch.int32 and ts_t.dim() == 0 and int(ts_t) == int(ts_j), name


def test_integrate_frame_chained_and_from_tensors(rng):
    """Chained per chunk (the reference's protocol) and fed tensors."""
    ev = _events(rng, 300, 12, 17)
    out_t = out_j = None
    for i in range(0, 300, 37):
        out_j = jint.integrate_frame(ev[i:i + 37], 1e-2, 12, 17, out_j)
        out_t = tint.integrate_frame(torch.from_numpy(ev[i:i + 37]), 1e-2, 12, 17, out_t,
                                     device="cpu")
    _assert_bits(out_t[0], out_j[0])
    assert int(out_t[1]) == int(out_j[1])
    assert (out_t[0] == 0).any()  # the chain crosses the clamps


@pytest.mark.parametrize("n,slice_len", [(300, 64), (256, 64), (40, 64), (0, 64), (1, 8)])
def test_integrate_frame_chunked_bit_exact(rng, n, slice_len):
    """Ragged last slices (padded with their final event), a stream shorter
    than a slice, and the empty stream."""
    ev = _events(rng, n, 12, 17, max_dt=8)
    prev = (np.full((12, 17), 0.25, np.float32), np.int32(3))
    for p_j, p_t in ((None, None), ((jnp.asarray(prev[0]), jnp.asarray(prev[1])),
                                    (torch.from_numpy(prev[0]), 3))):
        f_j, ts_j = jint.integrate_frame_chunked(ev, 1e-2, 12, 17, p_j, slice_len=slice_len)
        f_t, ts_t = tint.integrate_frame_chunked(ev, 1e-2, 12, 17, p_t, slice_len=slice_len,
                                                 device="cpu")
        _assert_bits(f_t, f_j)
        assert int(ts_t) == int(ts_j)


# ---- frame models and oracles ------------------------------------------------------


def test_three_way_model_consistency(rng):
    """The event model, the frame model and the numpy oracle on one stream
    (tests/test_models.py's check, in the port): the event grid within 1e-4
    of the frame grid; the numpy oracle, which re-applies the activation
    after each pool, within 1e-4 of dense_forward's 'numpy' variant."""
    kwargs = _model_args()
    params = _params(rng)
    ev = tyolo.YoloEventTorch(**kwargs, device="cpu")
    ft = tyolo.YoloFrameTorch(**kwargs, device="cpu")
    fn = tyolo.YoloFrameNumpy(**kwargs)
    for m in (ev, ft, fn):
        m.set_weights(params)
    graph = ev.build_graph(None)
    frame_state = None
    prev = 0
    for t in range(20):
        ts = np.sort(rng.randint(1, 50, size=10)) + prev
        prev = int(ts[-1])
        events = np.stack([rng.randint(0, 16, 10), rng.randint(0, 16, 10), ts],
                          -1).astype(np.int32)
        frame_state = tint.integrate_frame(events, kwargs["leak"], 16, 16, frame_state,
                                           device="cpu")
        out_ev = graph(events, t == 0)
    frame = frame_state[0]
    out_ft = ft.build_graph(None)(frame)
    out_fn = fn.build_graph(None)(frame.numpy())
    assert out_ev.shape == out_ft.shape == out_fn.shape == (4, 4, 12)
    np.testing.assert_allclose(out_ev, out_ft, atol=TOL, rtol=0)
    outs = tnet.dense_forward(ft.net.event_layers, ft.params, frame[None], "numpy",
                              alpha=kwargs["alpha"])
    want = next(reversed(outs.values())).permute(1, 2, 0).reshape(4, 4, 12).numpy()
    np.testing.assert_allclose(out_fn, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("base,channels", [(DSL, 1), (DSL, 2), (TAIL_DSL, 1)])
def test_yolo_frame_torch_matches_jax(rng, base, channels):
    """``[H, W]`` frames and channeled ``[C, H, W]`` ones, with and without
    the dense tail."""
    dsl = base.replace("3,3,1,4", f"3,3,{channels},4")
    kwargs = _model_args(dsl)
    params = _params(rng, dsl)
    jm = jyolo.YoloFrameJax(**kwargs)
    tm = tyolo.YoloFrameTorch(**kwargs, device="cpu")
    jm.set_weights(params)
    tm.set_weights(params)
    shape = (16, 16) if channels == 1 else (channels, 16, 16)
    for frame in (rng.rand(*shape).astype(np.float32), np.zeros(shape, np.float32)):
        got = tm.forward(frame)
        assert got.shape == (4, 4, 12) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(jm.forward(frame)), atol=TOL, rtol=0)
        np.testing.assert_allclose(tm.build_graph()(torch.from_numpy(frame)),
                                   np.asarray(jm.build_graph()(frame)), atol=TOL, rtol=0)


@pytest.mark.parametrize("dsl", [DSL, TAIL_DSL])
def test_yolo_frame_numpy_copy_matches_jax(rng, dsl):
    """The copied numpy oracle, with and without the fc tail, bit for bit:
    the same numpy operations on the same arrays."""
    kwargs = _model_args(dsl)
    params = _params(rng, dsl)
    jm, tm = jyolo.YoloFrameNumpy(**kwargs), tyolo.YoloFrameNumpy(**kwargs)
    jm.set_weights(params)
    tm.set_weights(params)
    frame = rng.rand(16, 16).astype(np.float32)
    _assert_bits(tm.forward(frame), jm.forward(frame))


def test_async_event_numpy_copy_matches_jax(rng):
    """The copied coordinate-list oracle, bit for bit over a stream with an
    empty chunk and a reset, 'SAME' and 'VALID' padding."""
    layer_defs = OrderedDict(
        [("conv1", [3, 3, 1, 4]), ("pool1", [2, 2]), ("conv2", [3, 3, 4, 6]), ("pool2", [2, 2])])
    params = _params(rng, "conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,6 pool2=2,2")
    for padding in ("SAME", "VALID"):
        jm = jcpu.AsyncEventNumpy(layer_defs, params, 16, 16, 0.05, alpha=0.1, padding=padding)
        tm = tcpu.AsyncEventNumpy(layer_defs, params, 16, 16, 0.05, alpha=0.1, padding=padding)
        prev = 0
        for t in range(25):
            events = _events(rng, 0 if t == 7 else 5, 16, 16, start=prev)
            prev = int(events[-1, 2]) if len(events) else prev
            _assert_bits(tm.step(events), jm.step(events))
            if t == 12:
                jm.reset()
                tm.reset()


# ---- ts_window and the max-plus engine ------------------------------------------------


def _chunks(arrays):
    return (TChunk(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)),
            JChunk(*(jnp.asarray(a) for a in arrays)))


def _clustered(rng, t, e, h, w, radius=2, start=0):
    """Events around one centre a chunk (each chunk's box fits a window of
    about 4 * radius)."""
    cy = rng.randint(radius, h - radius, (t, 1))
    cx = rng.randint(radius, w - radius, (t, 1))
    y = np.clip(cy + rng.randint(-radius, radius + 1, (t, e)), 0, h - 1).astype(np.int32)
    x = np.clip(cx + rng.randint(-radius, radius + 1, (t, e)), 0, w - 1).astype(np.int32)
    ts = (start + np.cumsum(rng.randint(1, 20, t * e))).astype(np.int32).reshape(t, e)
    return [y, x, ts, np.zeros((t, e), np.int32), rng.rand(t, e) < 0.9]


@pytest.mark.parametrize("overflow", [False, True])
def test_ts_window_matches_jax(rng, overflow):
    """``ts_window`` through ``chunk_ts_maps``, ``integrate_parallel`` and
    ``scan_parallel`` against the JAX package's windowed ts maps
    ('pallas_tsmap'), when every chunk fits the window and when one
    overflows it (the JAX package then takes its full compare)."""
    h, w, win = 16, 24, (6, 6)
    arrays = _clustered(rng, 6, 10, h, w)
    if overflow:
        arrays[0][3, 0], arrays[1][3, 0] = 0, 0
        arrays[0][3, 1], arrays[1][3, 1] = h - 1, w - 1
        arrays[4][3, :2] = True
    tc, jc = _chunks(arrays)
    m_t, d_t, lt_t = tint.chunk_ts_maps(1, h, w, 4, tc, 1e-3, ts_window=win)
    m_j, d_j, lt_j = jint.chunk_ts_maps(1, h, w, jnp.int32(4), jc, 1e-3, ts_window=win)
    for got, want in ((m_t, m_j), (d_t, d_j), (lt_t, lt_j)):
        _assert_bits(got, want)
    s0 = (np.round(rng.rand(1, h, w) * 2**20) / 2**20).astype(np.float32)
    s_t, _ = tint.integrate_parallel(torch.from_numpy(s0), 4, tc, 1e-3, ts_window=win,
                                     engine="tsmap")
    s_j, _ = jint.integrate_parallel(jnp.asarray(s0), jnp.int32(4), jc, 1e-3, ts_window=win,
                                     engine="pallas_tsmap")
    _assert_bits(s_t, s_j)

    ld = layers_dict("conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,6")
    params = _params(rng, "conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,6")
    tn = tnet.EventNetwork(ld, h, w, 1e-3, padding="SAME", conv_mode="full")
    jn = jnet.EventNetwork(ld, h, w, 1e-3, padding="SAME", conv_mode="full")
    tp = params_from_jax(params, "cpu")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    t_st, t_out = tn.scan_parallel(tp, tn.init_state(tp, "cpu"), tc, ts_window=win,
                                   integrate_engine="tsmap")
    j_st, j_out = jn.scan_parallel(jp, jn.init_state(jp), jc, ts_window=win,
                                   integrate_engine="pallas_tsmap")
    _assert_bits(t_st[0].surface, j_st[0].surface)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=TOL, rtol=0)
    e_st, e_out = tn.scan_parallel(tp, tn.init_state(tp, "cpu"), tc)
    _assert_bits(t_st[0].surface, e_st[0].surface)


def test_yolo_ts_window_validation_and_plumbing(rng):
    """``ts_window < 1`` raises naming it, as in the JAX package; a valid
    window reaches scan_parallel and changes no grid."""
    kw = dict(_model_args(), conv_mode="full", device="cpu")
    for bad in (-3, 0):
        with pytest.raises(ValueError, match="ts_window"):
            tyolo.YoloEventTorch(**kw, ts_window=bad)
    params = _params(rng)
    plain = tyolo.YoloEventTorch(**kw)
    windowed = tyolo.YoloEventTorch(**kw, ts_window=4)
    plain.set_weights(params)
    windowed.set_weights(params)
    seen = []
    scan_parallel = windowed.net.scan_parallel

    def spy(*args, **kwargs):
        seen.append(kwargs.get("ts_window"))
        return scan_parallel(*args, **kwargs)

    windowed.net.scan_parallel = spy
    tc, _ = _chunks(_clustered(rng, 5, 8, 16, 16))
    _, a = windowed.scan(windowed.init_state(), tc)
    _, b = plain.scan(plain.init_state(), tc)
    assert seen == [(4, 4)]
    _assert_bits(a, b)


def _random_chunks(rng, t, e, h, w, channels):
    ts = np.cumsum(rng.randint(1, 40, t * e)).astype(np.int32).reshape(t, e)
    return [rng.randint(0, h, (t, e)).astype(np.int32),
            rng.randint(0, w, (t, e)).astype(np.int32), ts,
            rng.randint(0, channels, (t, e)).astype(np.int32), rng.rand(t, e) < 0.8]


@pytest.mark.parametrize("t,channels", [(1, 1), (7, 1), (33, 1), (12, 2)])
def test_maxplus_engine_matches_jax_xla(rng, t, channels):
    """'maxplus' bit for bit against the JAX 'xla' engine (odd and even
    lengths at every level of the scan's recursion), within 1e-6 of the
    port's 'events' engine, and its scan against jax.lax.associative_scan
    directly."""
    h, w = 9, 13
    tc, jc = _chunks(_random_chunks(rng, t, 10, h, w, channels))
    s0 = (np.round(rng.rand(channels, h, w) * 2**20) / 2**20).astype(np.float32)
    s_t, lt_t = tint.integrate_parallel(torch.from_numpy(s0), 3, tc, 2e-3, engine="maxplus")
    s_j, lt_j = jint.integrate_parallel(jnp.asarray(s0), jnp.int32(3), jc, 2e-3, engine="xla")
    _assert_bits(s_t, s_j)
    _assert_bits(lt_t, lt_j)
    s_e, _ = tint.integrate_parallel(torch.from_numpy(s0), 3, tc, 2e-3, engine="events")
    np.testing.assert_allclose(s_t.numpy(), s_e.numpy(), atol=ENGINE_TOL, rtol=0)

    b_t, c_t, _ = tint.chunk_affine_updates(channels, h, w, 3, tc, 2e-3)
    b_j, c_j, _ = jint.chunk_affine_updates(channels, h, w, jnp.int32(3), jc, 2e-3)
    _assert_bits(b_t, b_j)
    _assert_bits(c_t, c_j)
    scan_t = tint.associative_scan(tint.maxplus_combine, (b_t, c_t))
    scan_j = jax.lax.associative_scan(jint.maxplus_combine, (b_j, c_j))
    for got, want in zip(scan_t, scan_j):
        _assert_bits(got, want)


def test_maxplus_scan_parallel(rng):
    """``scan_parallel(integrate_engine='maxplus')`` against the JAX
    package's default CPU engine ('xla')."""
    ld = layers_dict("conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,6")
    params = _params(rng, "conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,6")
    tn = tnet.EventNetwork(ld, 16, 16, 2e-3, padding="SAME", conv_mode="full")
    jn = jnet.EventNetwork(ld, 16, 16, 2e-3, padding="SAME", conv_mode="full")
    tp = params_from_jax(params, "cpu")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tc, jc = _chunks(_random_chunks(rng, 11, 12, 16, 16, 1))
    t_st, t_out = tn.scan_parallel(tp, tn.init_state(tp, "cpu"), tc, window=4,
                                   integrate_engine="maxplus")
    j_st, j_out = jn.scan_parallel(jp, jn.init_state(jp), jc, window=4, integrate_engine="xla")
    _assert_bits(t_st[0].surface, j_st[0].surface)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=TOL, rtol=0)
