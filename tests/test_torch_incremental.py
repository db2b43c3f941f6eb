"""The port's incremental (sequential) event engine held against the JAX
package: ``integration_step``, ``conv_step`` in every conv mode (with the
overflow and window-miss fallbacks), ``pool_step`` and its full-recompute
oracle, ``EventNetwork.forward``/``scan``, ``YoloEventTorch.step``/``scan``/
``build_graph``, and the port's own async == dense gate.

Tolerances: ``integration_step`` bit for bit; ``pool_step`` exact (it
selects, it does not add); ``conv_step`` states within 1e-5 absolute, masks
equal (float32 convs and rulebook products whose sums run in another
order); network states and outputs within 1e-4 absolute, the contract of
tests/test_equivalence.py.  The JAX 'sparse_pallas' mode runs its Pallas
kernels in interpret mode on the CPU; the port's runs the kernels' plain
versions there.
"""

from collections import Counter, OrderedDict

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from async_ev_cnn_torch.layers import conv2d as tconv
from async_ev_cnn_torch.layers import integration as tint
from async_ev_cnn_torch.layers import maxpool as tpool
from async_ev_cnn_torch.layers import network as tnet
from async_ev_cnn_torch.layers.types import ConvState as TConvState
from async_ev_cnn_torch.layers.types import EventChunk as TChunk
from async_ev_cnn_torch.layers.types import LayerIO as TIO
from async_ev_cnn_torch.layers.types import PoolState as TPoolState
from async_ev_cnn_torch.models.yolo import YoloEventTorch
from async_ev_cnn_torch.utils import equivalence as teq
from async_ev_cnn_torch.utils.weights import params_from_jax
from async_ev_cnn_tpu.layers import conv2d as jconv
from async_ev_cnn_tpu.layers import integration as jint
from async_ev_cnn_tpu.layers import maxpool as jpool
from async_ev_cnn_tpu.layers import network as jnet
from async_ev_cnn_tpu.layers.types import ConvState as JConvState
from async_ev_cnn_tpu.layers.types import EventChunk as JChunk
from async_ev_cnn_tpu.layers.types import LayerIO as JIO
from async_ev_cnn_tpu.layers.types import PoolState as JPoolState
from async_ev_cnn_tpu.models.yolo import YoloEventJax
from async_ev_cnn_tpu.utils import equivalence as jeq
from async_ev_cnn_tpu.utils.config import layers_dict

torch.set_num_threads(2)
TOL = 1e-4
CONV_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _eq(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _close(got, want, atol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def _bits(a):
    return _np(a).view(np.int32)


def _both_chunks(arrays):
    return (TChunk(*(_t(a) for a in arrays)), JChunk(*(jnp.asarray(a) for a in arrays)))


def _chunk_arrays(rng, t, e, h, w, occupancy=0.8):
    ts = np.cumsum(rng.randint(1, 40, t * e)).astype(np.int32).reshape(t, e)
    return (rng.randint(0, h, (t, e)).astype(np.int32),
            rng.randint(0, w, (t, e)).astype(np.int32), ts,
            rng.randint(0, 2, (t, e)).astype(np.int32), rng.rand(t, e) < occupancy)


def _params(layer_defs, rng, scale=0.3):
    out = {}
    for name, size in layer_defs.items():
        if "conv" in name:
            out[f"w_{name}"] = (rng.randn(*size) * scale).astype(np.float32)
            out[f"b_{name}"] = (rng.randn(size[3]) * 0.1).astype(np.float32)
    return out


def _both_params(params):
    return params_from_jax(params, "cpu"), {k: jnp.asarray(v) for k, v in params.items()}


# ---- integration_step -------------------------------------------------------


@pytest.mark.parametrize("channels", [1, 2])
def test_integration_step_bit_exact(rng, channels):
    h, w = 9, 12
    tspec = tint.IntegrationSpec(leak=2e-3, h=h, w=w, channels=channels)
    jspec = jint.IntegrationSpec(leak=2e-3, h=h, w=w, channels=channels)
    t_st, _ = tint.integration_init(tspec, "cpu")
    j_st, _ = jint.integration_init(jspec)
    tc, jc = _both_chunks(_chunk_arrays(rng, 6, 10, h, w))
    for i in range(6):
        t_st, t_io, t_dl = tint.integration_step(tspec, t_st, TChunk(*(f[i] for f in tc)))
        j_st, j_io, j_dl = jint.integration_step(jspec, j_st, JChunk(*(f[i] for f in jc)))
        _eq(_bits(t_st.surface), _bits(j_st.surface))
        assert int(t_st.prev_ts) == int(j_st.prev_ts)
        _eq(_bits(t_dl), _bits(j_dl))
        for f in ("layer_actfn", "conv_actfn"):
            _eq(_bits(getattr(t_io, f)), _bits(getattr(j_io, f)), f)
        _eq(t_io.mask, j_io.mask)


# ---- conv_step ----------------------------------------------------------------

C_IN, C_OUT, H, W = 3, 4, 16, 24


def _mask_from(h, w, points):
    m = np.zeros((h, w), bool)
    for y, x in points:
        m[y, x] = True
    return m


def _conv_inputs(rng, spec_kw, points):
    o, oh, ow = jconv.ConvSpec(**spec_kw).out_shape
    surface = rng.randn(C_IN, H, W).astype(np.float32)
    actfn = np.where(surface > 0, 1.0, 0.1).astype(np.float32)
    cact = (rng.rand(C_IN, H, W) * 0.5).astype(np.float32)
    mask = _mask_from(H, W, points)
    fm = rng.randn(o, oh, ow).astype(np.float32)
    ca = (rng.rand(o, oh, ow) * 0.5).astype(np.float32)
    kernel = (rng.randn(o, C_IN, 3, 3) * 0.3).astype(np.float32)
    bias = (rng.randn(o) * 0.1).astype(np.float32)
    return (surface, actfn, cact, mask), (fm, ca), kernel, bias


FEW = [(5, 5), (6, 6)]          # a tight cluster: fits every capacity below
MANY = [(y, x) for y in range(0, H, 3) for x in range(0, W, 4)]  # spread out

CONV_CASES = {
    "dense": (dict(mode="dense"), FEW, 0),
    "sparse": (dict(mode="sparse"), FEW, 0),
    "sparse-stride2": (dict(mode="sparse", stride=2), FEW, 0),
    "sparse-overflow": (dict(mode="sparse", capacity_frac=0.02), MANY, 1),
    "sparse_pallas-K3": (dict(mode="sparse_pallas"), FEW, 0),
    "sparse_pallas-K4": (dict(mode="sparse_pallas", stride=2), FEW, 0),
    "sparse_pallas-overflow": (dict(mode="sparse_pallas", capacity_frac=0.02), MANY, 1),
    "sparse_pallas-K4-overflow": (dict(mode="sparse_pallas", stride=2,
                                       capacity_frac=0.02), MANY, 1),
    "sparse_rows": (dict(mode="sparse_rows", capacity_frac=0.5), FEW, 0),
    "sparse_rows-stride2": (dict(mode="sparse_rows", stride=2, capacity_frac=0.5), FEW, 0),
    "sparse_rows-overflow": (dict(mode="sparse_rows", capacity_frac=0.02), MANY, 1),
    "window": (dict(mode="window"), FEW, 0),
    "window-miss": (dict(mode="window"), MANY, 1),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv_step_matches_jax(rng, case):
    """Two chained steps from the same state and inputs; the second step's
    input mask is the first step's output mask, as in a network."""
    kw, points, fallbacks = CONV_CASES[case]
    spec_kw = dict(dict(in_shape=(C_IN, H, W), out_channels=C_OUT, ksize=(3, 3),
                        stride=1, alpha=0.1, padding="SAME"), **kw)
    tspec, jspec = tconv.ConvSpec(**spec_kw), jconv.ConvSpec(**spec_kw)
    (surface, actfn, cact, mask), (fm, ca), kernel, bias = _conv_inputs(rng, spec_kw, points)
    t_st, j_st = TConvState(_t(fm), _t(ca)), JConvState(jnp.asarray(fm), jnp.asarray(ca))
    counts = Counter()
    for step, leak in enumerate((0.013, 0.0071)):
        dl = np.float32(leak)
        t_io = TIO(_t(surface), _t(actfn), _t(cact), _t(mask))
        j_io = JIO(*(jnp.asarray(a) for a in (surface, actfn, cact, mask)))
        t_st, t_out = tconv.conv_step(tspec, _t(kernel), _t(bias), t_st, t_io,
                                      torch.tensor(dl), counts=counts)
        j_st, j_out = jconv.conv_step(jspec, jnp.asarray(kernel), jnp.asarray(bias),
                                      j_st, j_io, jnp.float32(dl))
        what = f"{case} step {step}"
        _close(t_st.featuremap, j_st.featuremap, CONV_TOL, what)
        _close(t_st.conv_actfn, j_st.conv_actfn, CONV_TOL, what)
        _eq(t_out.mask, j_out.mask, what)
        _close(t_out.featuremap, j_out.featuremap, CONV_TOL, what)
        _close(t_out.conv_actfn, j_out.conv_actfn, CONV_TOL, what)
        # the next step starts from the output's mask, cropped/padded to H x W
        m = np.zeros((H, W), bool)
        om = _np(j_out.mask)
        m[: om.shape[0], : om.shape[1]] = om
        mask = m if fallbacks else mask
        surface = surface * np.float32(0.9)
    syncs = 0 if kw["mode"] == "dense" else 2
    assert counts["host_syncs"] == syncs and counts["kernel_launches"] == 0
    assert (counts["dense_fallbacks"] > 0) == bool(fallbacks), counts


# ---- pool_step ----------------------------------------------------------------


def _pool_io(rng, c, h, w, p):
    surface = rng.randint(-2, 3, (c, h, w)).astype(np.float32)  # ties
    actfn = np.where(surface > 0, 1.0, 0.1).astype(np.float32)
    cact = rng.randint(0, 3, (c, h, w)).astype(np.float32)
    mask = rng.rand(h, w) < p
    return surface, actfn, cact, mask


@pytest.mark.parametrize("full_recompute", [False, True])
def test_pool_step_matches_jax(rng, full_recompute):
    c, h, w = 3, 10, 14
    spec_kw = dict(in_shape=(c, h, w), ksize=(2, 2), stride=2)
    tspec, jspec = tpool.PoolSpec(**spec_kw), jpool.PoolSpec(**spec_kw)
    arrays = _pool_io(rng, c, h, w, 0.0)
    t_st, t_io = tpool.pool_init(tspec, TIO(*(_t(a) for a in arrays)))
    j_st, j_io = jpool.pool_init(jspec, JIO(*(jnp.asarray(a) for a in arrays)))
    for f in ("surface", "layer_actfn", "conv_actfn", "mask"):
        _eq(getattr(t_io, f), getattr(j_io, f), f)
    t_fn = tpool.pool_step_full_recompute if full_recompute else tpool.pool_step
    j_fn = jpool.pool_step_full_recompute if full_recompute else jpool.pool_step
    for step in range(4):
        arrays = _pool_io(rng, c, h, w, 0.15)
        t_st, t_io = t_fn(tspec, t_st, TIO(*(_t(a) for a in arrays)), 0.0)
        j_st, j_io = j_fn(jspec, j_st, JIO(*(jnp.asarray(a) for a in arrays)), 0.0)
        _eq(t_st.idx_max, j_st.idx_max, f"idx step {step}")
        _eq(t_st.recompute, j_st.recompute, f"recompute step {step}")
        for f in ("surface", "layer_actfn", "conv_actfn", "mask"):
            _eq(getattr(t_io, f), getattr(j_io, f), f"{f} step {step}")
    assert isinstance(t_st, TPoolState) and isinstance(j_st, JPoolState)


# ---- the network --------------------------------------------------------------

NH, NW = 16, 24
NET_DSL = "conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,7 pool2=2,2"
MIXED_DSL = "conv1=3,3,1,4@window pool1=2,2 conv2=3,3,4,7@full pool2=2,2"


def _nets(dsl, mode, **kw):
    ld = layers_dict(dsl)
    args = (ld, NH, NW, 5e-3, 0.1, "SAME")
    kw = dict(conv_mode=mode, capacity_frac=0.25, **kw)
    return ld, tnet.EventNetwork(*args, **kw), jnet.EventNetwork(*args, **kw)


def _compare_states(t_state, j_state, what):
    """Float state within TOL, prev_ts and the pools' recompute sets equal.
    A pool's argmax index is not compared: where two window values tie
    exactly in one package, convs that sum in another order can split them
    by an ulp in the other, and the index flips between values within the
    tolerance (the pooled featuremaps, compared by the callers, hold)."""
    for i, (ts, js) in enumerate(zip(t_state, j_state)):
        for f, jv in zip(js._fields, js):
            tv = getattr(ts, f)
            if f == "idx_max":
                assert tuple(tv.shape) == jv.shape
            elif f == "prev_ts" or jv.dtype != jnp.float32:
                _eq(tv, jv, f"{what} layer {i} {f}")
            else:
                _close(tv, jv, TOL, f"{what} layer {i} {f}")


@pytest.mark.parametrize("mode,dsl", [
    ("dense", NET_DSL), ("sparse", NET_DSL), ("sparse_pallas", NET_DSL),
    ("sparse_rows", NET_DSL), ("window", NET_DSL), ("dense", MIXED_DSL),
])
def test_forward_matches_jax_per_step(rng, mode, dsl):
    """Per-step states and every layer's featuremap and mask.  The mixed
    configuration runs a window layer into 'full' layers."""
    ld, tn, jn = _nets(dsl, mode)
    tp, jp = _both_params(_params(ld, rng))
    tc, jc = _both_chunks(_chunk_arrays(rng, 8, 6, NH, NW))
    t_state, j_state = tn.init_state(tp, "cpu"), jn.init_state(jp)
    _compare_states(t_state, j_state, "init")
    for i in range(8):
        t_state, t_ios = tn.forward(tp, t_state, TChunk(*(f[i] for f in tc)))
        j_state, j_ios = jn.forward(jp, j_state, JChunk(*(f[i] for f in jc)))
        _compare_states(t_state, j_state, f"step {i}")
        assert list(t_ios) == list(j_ios)
        for name, jio in j_ios.items():
            _close(t_ios[name].featuremap, jio.featuremap, TOL, f"step {i} {name}")
            if t_ios[name].mask is not None:
                _eq(t_ios[name].mask, jio.mask, f"step {i} {name} mask")
    if mode in ("sparse", "sparse_pallas", "sparse_rows", "window"):
        assert all(c["host_syncs"] == 8 for c in tn.layer_counts.values())


def test_forward_upto_and_scan_match_jax(rng):
    ld, tn, jn = _nets(NET_DSL, "sparse")
    tp, jp = _both_params(_params(ld, rng))
    tc, jc = _both_chunks(_chunk_arrays(rng, 6, 5, NH, NW))
    t_state, j_state = tn.init_state(tp, "cpu"), jn.init_state(jp)
    c0t, c0j = TChunk(*(f[0] for f in tc)), JChunk(*(f[0] for f in jc))
    for upto in (0, 2):  # INCLUSIVE over event_layers
        t_st, t_ios = tn.forward(tp, t_state, c0t, upto=upto)
        j_st, j_ios = jn.forward(jp, j_state, c0j, upto=upto)
        assert list(t_ios) == list(j_ios) and len(t_ios) == upto + 1
        _compare_states(t_st, j_st, f"upto {upto}")
    t_st, t_out = tn.scan(tp, t_state, tc)
    j_st, j_out = jn.scan(jp, j_state, jc)
    _compare_states(t_st, j_st, "scan")
    _close(t_out, j_out, TOL, "scan outputs")


# ---- the model ----------------------------------------------------------------


def _models(mode):
    ld = layers_dict(NET_DSL)
    kw = dict(h_frame=NH, w_frame=NW, num_classes=2, cnn_layers=ld, cnn_padding="SAME",
              h_cells=4, w_cells=6, num_bbox=1, alpha=0.1, leak=5e-3, conv_mode=mode)
    return ld, YoloEventTorch(**kw, device="cpu"), YoloEventJax(**kw)


def test_yolo_step_scan_build_graph_match_jax(rng):
    ld, tm, jm = _models("sparse")
    params = _params(ld, rng)
    tm.set_weights(params)
    jm.set_weights(params)
    tc, jc = _both_chunks(_chunk_arrays(rng, 5, 6, NH, NW))
    t_st, t_grids = tm.scan(tm.init_state(), tc)   # sequential: not all 'full'
    j_st, j_grids = jm.scan(jm.init_state(), jc)
    assert tuple(t_grids.shape) == j_grids.shape == (5, 4, 6, 7)
    _close(t_grids, j_grids, TOL, "scan")
    _compare_states(t_st, j_st, "scan")
    t_st, t_g = tm.step(t_st, TChunk(*(f[0] for f in tc)))
    j_st, j_g = jm.step(j_st, JChunk(*(f[0] for f in jc)))
    _close(t_g, j_g, TOL, "step")
    tg, jg = tm.build_graph(None), jm.build_graph(None)
    for i, n in enumerate((3, 0, 17)):  # 17 events pad to a capacity of 32
        ev = np.stack([rng.randint(0, NH, n), rng.randint(0, NW, n),
                       np.sort(rng.randint(0, 50, n)) + 100 * i], -1).astype(np.int32)
        got, want = tg(ev, reset=i == 0), jg(ev, reset=i == 0)
        assert isinstance(got, np.ndarray)
        _close(got, want, TOL, f"build_graph call {i}")


def test_yolo_scan_routes_full_mode_parallel_and_large_frames_sequential(rng, monkeypatch):
    """All-'full' models take scan_parallel up to PARALLEL_MAX_PIXELS and
    the sequential engine above it; both give the same grids."""
    ld, tm, _ = _models("full")
    tm.set_weights(_params(ld, rng))
    tc, _ = _both_chunks(_chunk_arrays(rng, 4, 6, NH, NW))
    calls = []
    orig = tm.net.scan
    monkeypatch.setattr(tm.net, "scan", lambda *a: calls.append(1) or orig(*a))
    st0 = tm.init_state()
    _, par = tm.scan(st0, tc)
    assert not calls
    monkeypatch.setattr(tm, "PARALLEL_MAX_PIXELS", NH * NW - 1)
    _, seq = tm.scan(st0, tc)
    assert calls
    _close(seq, par, TOL, "sequential vs parallel")


# ---- the port's async == dense gate -----------------------------------------


def _reference_net(mode="dense", frame=8, leak=0.1, capacity_frac=0.25):
    """The reference's test net: fixed 3x3 kernel [[-2,-1,1]]x3, bias 10."""
    k = np.array([[-2, -1, 1]] * 3, np.float32).reshape(3, 3, 1, 1)
    ld = OrderedDict([("conv1", [3, 3, 1, 1]), ("pool1", [2, 2]),
                      ("conv2", [3, 3, 1, 1]), ("pool2", [2, 2])])
    params = params_from_jax({"w_conv1": k, "b_conv1": np.float32([10.0]),
                              "w_conv2": k, "b_conv2": np.float32([10.0])}, "cpu")
    net = tnet.EventNetwork(ld, frame, frame, leak, 0.1, "SAME", conv_mode=mode,
                            capacity_frac=capacity_frac)
    return net, params


def _check(report):
    for name, diff in report.max_diff.items():
        assert diff <= TOL, (name, diff, report.worst_step[name], dict(report.max_diff))


def test_make_stream_matches_jax():
    for kw in (dict(), dict(clustered=True, cluster_radius=3, random_polarity=True)):
        got = teq.make_stream(np.random.RandomState(5), 7, 9, 12, 20, device="cpu", **kw)
        want = jeq.make_stream(np.random.RandomState(5), 7, 9, 12, 20, **kw)
        for g, w_ in zip(got, want):
            _eq(g, w_)


def test_equivalence_1k_steps_dense(rng):
    net, params = _reference_net()
    chunks = teq.make_stream(rng, 1000, 5, 8, 8, device="cpu")
    _check(teq.run_equivalence(net, params, chunks, device="cpu"))


@pytest.mark.parametrize("mode,capacity_frac", [
    ("sparse", 0.5), ("sparse_pallas", 0.5), ("sparse_rows", 0.5), ("window", 0.25),
    ("sparse_pallas", 0.02), ("full", 0.25),
])
def test_equivalence_modes(rng, mode, capacity_frac):
    net, params = _reference_net(mode, frame=16, leak=0.05, capacity_frac=capacity_frac)
    chunks = teq.make_stream(rng, 300, 4, 16, 16, device="cpu")
    report = teq.run_equivalence(net, params, chunks, device="cpu")
    _check(report)
    if mode == "full":
        assert max(report.max_diff.values()) == 0.0


def test_equivalence_clustered_window_and_polarity(rng):
    net, params = _reference_net("window", frame=32, leak=0.05)
    chunks = teq.make_stream(rng, 200, 6, 32, 32, clustered=True, device="cpu")
    _check(teq.run_equivalence(net, params, chunks, device="cpu"))
    ld = layers_dict("conv1=3,3,2,4 pool1=2,2 conv2=3,3,4,6 pool2=2,2")
    net = tnet.EventNetwork(ld, 16, 16, 0.05, 0.1, "SAME", conv_mode="sparse_pallas")
    params = params_from_jax(_params(ld, rng), "cpu")
    chunks = teq.make_stream(rng, 200, 6, 16, 16, random_polarity=True, device="cpu")
    _check(teq.run_equivalence(net, params, chunks, device="cpu"))


@pytest.mark.slow
def test_equivalence_10k_steps(rng):
    net, params = _reference_net()
    chunks = teq.make_stream(rng, 10000, 5, 8, 8, device="cpu")
    _check(teq.run_equivalence(net, params, chunks, device="cpu"))


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["dense", "sparse_pallas"])
def test_equivalence_full_efcn_scale(rng, mode):
    """The eFCN at 160x224, 12 layers, the JAX package's own full-scale
    case (30 steps x 200 events, max_dt 30, weights x 0.05)."""
    ld = layers_dict(
        "conv1=3,3,1,16 pool1=2,2 conv2=3,3,16,32 pool2=2,2 conv3=3,3,32,64 pool3=2,2 "
        "conv4=3,3,64,128 pool4=2,2 conv5=3,3,128,256 pool5=2,2 conv6=1,1,256,512 "
        "conv7=1,1,512,110")
    params = {}
    for name, size in ld.items():
        if "conv" in name:
            params[f"w_{name}"] = rng.randn(*size).astype(np.float32) * 0.05
            params[f"b_{name}"] = rng.randn(size[3]).astype(np.float32) * 0.05
    net = tnet.EventNetwork(ld, 160, 224, 5e-5, 0.1, "SAME", conv_mode=mode)
    chunks = teq.make_stream(rng, 30, 200, 160, 224, max_dt=30, device="cpu")
    _check(teq.run_equivalence(net, params_from_jax(params, "cpu"), chunks,
                               device="cpu"))
