"""The port's space-to-depth stem fusion (async_ev_cnn_torch/ops/stem.py and
the fused branch of EventNetwork.full_frame_forward) held against the JAX
package on the same numpy inputs, mirroring tests/test_stem.py.

Tolerances: ``space_to_depth`` and ``build_s2d_kernel`` are permutations
(bit for bit); the pair selection and the fusion predicate are exact
(sets and booleans); ``fused_conv_pool`` against the JAX one and against
the direct conv -> leaky -> pool, and the fused forward against the
layer-by-layer one, are within 1e-5 absolute (float32 sums of up to 36*Cin
terms in another order).  On the CPU the matmul tier changes no number in
either package, so every tier compares at these float32 tolerances.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from async_ev_cnn_torch.layers import network as tnet
from async_ev_cnn_torch.ops import conv as tconv
from async_ev_cnn_torch.ops import pool as tpool
from async_ev_cnn_torch.ops import stem as tstem
from async_ev_cnn_torch.utils.weights import params_from_jax
from async_ev_cnn_tpu.layers import network as jnet
from async_ev_cnn_tpu.ops import conv as jconv
from async_ev_cnn_tpu.ops import stem as jstem
from async_ev_cnn_tpu.utils.config import layers_dict

torch.set_num_threads(2)
TOL = 1e-5
EFCN_HEAD = ("conv1=3,3,1,16 pool1=2,2 conv2=3,3,16,32 pool2=2,2 "
             "conv3=3,3,32,64 pool3=2,2 conv4=1,1,64,12")
SMALL = "conv1=3,3,1,4 pool1=2,2 conv2=1,1,4,6"
TWO_PAIRS = "conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,8 pool2=2,2 conv3=1,1,8,6"


def _t(a):
    return torch.from_numpy(np.array(a))


def _params(dsl, rng):
    out = {}
    for name, size in layers_dict(dsl).items():
        if "conv" in name:
            kh, kw, ci, co = size
            out[f"w_{name}"] = (rng.randn(kh, kw, ci, co) * 0.3).astype(np.float32)
            out[f"b_{name}"] = (rng.randn(co) * 0.1).astype(np.float32)
    return out


class _Tier:
    """Set the tier and the demoted-precision flag in both packages; put
    both back to 'highest' and the flag's old value on exit."""

    def __init__(self, tier, allow=True):
        self.tier, self.allow = tier, allow

    def __enter__(self):
        self.old = (tstem.allow_demoted_precision, jstem.allow_demoted_precision)
        tconv.set_matmul_precision(self.tier)
        jconv.set_matmul_precision(self.tier)
        tstem.allow_demoted_precision = jstem.allow_demoted_precision = self.allow

    def __exit__(self, *exc):
        tstem.allow_demoted_precision, jstem.allow_demoted_precision = self.old
        tconv.set_matmul_precision("highest")
        jconv.set_matmul_precision("highest")


@pytest.mark.parametrize("shape", [(3, 4, 6), (2, 1, 8, 10), (2, 3, 2, 4, 6)])
def test_space_to_depth_matches_jax(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    got = tstem.space_to_depth(_t(x))
    want = jstem.space_to_depth(jnp.asarray(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("o,cin", [(4, 1), (3, 2), (8, 16)])
def test_build_s2d_kernel_matches_jax(rng, o, cin):
    k = rng.randn(o, cin, 3, 3).astype(np.float32)
    got = tstem.build_s2d_kernel(_t(k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jstem.build_s2d_kernel(jnp.asarray(k))))
    with pytest.raises(ValueError, match="3x3"):
        tstem.build_s2d_kernel(_t(rng.randn(o, cin, 1, 1).astype(np.float32)))


@pytest.mark.parametrize("cin,cout,h,w", [(1, 16, 16, 24), (2, 8, 12, 12), (16, 32, 8, 14)])
def test_fused_conv_pool_matches_jax_and_direct(rng, cin, cout, h, w):
    x = rng.randn(cin, h, w).astype(np.float32)
    k = (rng.randn(cout, cin, 3, 3) * 0.3).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    got = tstem.fused_conv_pool(_t(x), _t(k), _t(b), 0.1)
    want = jstem.fused_conv_pool(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), 0.1)
    assert tuple(got.shape) == want.shape == (cout, h // 2, w // 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    direct = tpool.maxpool_dense(
        tconv.leaky(tconv.conv2d_dense(_t(x), _t(k), _t(b), 1, "SAME"), 0.1), (2, 2), 2)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=0, atol=TOL)
    # a batch [N, C, H, W] gives each frame's result
    xb = np.stack([x, rng.randn(cin, h, w).astype(np.float32)])
    batch = tstem.fused_conv_pool(_t(xb), _t(k), _t(b), 0.1)
    for i in range(2):
        one = tstem.fused_conv_pool(_t(xb[i]), _t(k), _t(b), 0.1)
        np.testing.assert_allclose(batch[i].numpy(), one.numpy(), rtol=0, atol=TOL)


def test_pair_predicates_match_jax():
    from async_ev_cnn_torch.layers.conv2d import ConvSpec as TConv
    from async_ev_cnn_torch.layers.maxpool import PoolSpec as TPool
    from async_ev_cnn_tpu.layers.conv2d import ConvSpec as JConv
    from async_ev_cnn_tpu.layers.maxpool import PoolSpec as JPool

    for cin, h, w, k, stride, pad, mode, pk, ps in (
            (1, 32, 32, (3, 3), 1, "SAME", "full", (2, 2), 2),
            (2, 16, 24, (3, 3), 1, "SAME", "full", (2, 2), 2),
            (16, 32, 32, (3, 3), 1, "SAME", "full", (2, 2), 2),
            (1, 31, 32, (3, 3), 1, "SAME", "full", (2, 2), 2),
            (1, 32, 32, (1, 1), 1, "SAME", "full", (2, 2), 2),
            (1, 32, 32, (3, 3), 2, "SAME", "full", (2, 2), 2),
            (1, 32, 32, (3, 3), 1, "VALID", "full", (2, 2), 2),
            (1, 32, 32, (3, 3), 1, "SAME", "dense", (2, 2), 2),
            (1, 32, 32, (3, 3), 1, "SAME", "full", (3, 3), 3)):
        args = dict(in_shape=(cin, h, w), out_channels=8, ksize=k, stride=stride,
                    alpha=0.1, padding=pad, mode=mode)
        pool = dict(in_shape=(8, h, w), ksize=pk, stride=ps,
                    mode="full" if mode == "full" else "event")
        assert (tstem.s2d_pair_applicable(TConv(**args), TPool(**pool))
                == jstem.s2d_pair_applicable(JConv(**args), JPool(**pool)))
        assert tstem.s2d_pair_wins(TConv(**args)) == jstem.s2d_pair_wins(JConv(**args))


def test_network_selects_pairs_as_jax():
    """The candidate pairs, the 'auto'/True/False policy at 'highest', the
    clone and the rejected values, as tests/test_stem.py checks them."""
    ld = layers_dict(EFCN_HEAD)
    cases = ((160, 224, "full", True), (160, 224, "full", "auto"),
             (160, 224, "full", False), (161, 224, "full", True),
             (160, 224, "dense", True))
    for h, w, mode, fusion in cases:
        tn = tnet.EventNetwork(ld, h, w, leak=5e-5, alpha=0.1, padding="SAME",
                               conv_mode=mode, stem_fusion=fusion)
        jn = jnet.EventNetwork(ld, h, w, leak=5e-5, alpha=0.1, padding="SAME",
                               conv_mode=mode, stem_fusion=fusion)
        assert tn._s2d_pairs == jn._s2d_pairs
        assert tn._fusion_active() == jn._fusion_active()
    tn = tnet.EventNetwork(ld, 160, 224, leak=5e-5, alpha=0.1, padding="SAME",
                           conv_mode="full", stem_fusion=False)
    assert tn._s2d_pairs == frozenset({0}) and not tn._fusion_active()
    on = tn.with_stem_fusion(True)
    assert on._fusion_active() and not tn._fusion_active()
    assert on.event_layers is tn.event_layers
    for bad in (1, "yes"):
        with pytest.raises(ValueError, match="stem_fusion"):
            tn.with_stem_fusion(bad)
        with pytest.raises(ValueError, match="stem_fusion"):
            tnet.EventNetwork(ld, 160, 224, leak=5e-5, padding="SAME", conv_mode="full",
                              stem_fusion=bad)


@pytest.mark.parametrize("fusion", ["auto", True, False])
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_fusion_predicate_matches_jax(fusion, act):
    """'auto' / True / False x every tier x activation dtype x the
    demoted-precision flag: the port fuses exactly where the JAX package
    does."""
    ld = layers_dict(SMALL)
    kw = dict(leak=0.01, alpha=0.1, padding="SAME", conv_mode="full",
              stem_fusion=fusion, activation_dtype=act)
    tn = tnet.EventNetwork(ld, 16, 16, **kw)
    jn = jnet.EventNetwork(ld, 16, 16, **kw)
    seen = set()
    for tier in ("highest", "high", "default"):
        for allow in (True, False):
            with _Tier(tier, allow):
                got = tn._fusion_active()
                assert got == jn._fusion_active(), (tier, allow)
                seen.add((tier, allow, got))
    fused = {(t, a) for t, a, g in seen if g}
    if fusion is False:
        assert not fused
    elif fusion is True:
        assert fused == {("highest", True), ("highest", False), ("high", True),
                         ("default", True)}
    else:
        assert fused == ({("default", True)} if act == "float32" else set())


def _forward_counts(net, params, state, frame, **kw):
    tstem.reset_calls()
    out = net.full_frame_forward(params, state, frame, **kw)
    return out, tstem.CALLS["fused_conv_pool"]


def test_demoted_precision_flag_controls_fusion(rng):
    """stem_fusion=True: fused at 'highest'; at 'default' the flag decides;
    fused output within 1e-5 of the direct one (port and JAX)."""
    params = _params(SMALL, rng)
    tp = params_from_jax(params, "cpu")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    kw = dict(leak=0.01, alpha=0.1, padding="SAME", conv_mode="full", stem_fusion=True)
    tn = tnet.EventNetwork(layers_dict(SMALL), 16, 16, **kw)
    jn = jnet.EventNetwork(layers_dict(SMALL), 16, 16, **kw)
    ts, js = tn.init_state(tp, "cpu"), jn.init_state(jp)
    frame = rng.rand(1, 16, 16).astype(np.float32)
    with _Tier("highest"):
        got, n = _forward_counts(tn, tp, ts, _t(frame))
        assert n == 1
        want = jn.full_frame_forward(jp, js, jnp.asarray(frame))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    with _Tier("default", allow=False):
        ref, n = _forward_counts(tn, tp, ts, _t(frame))
        assert n == 0
    with _Tier("default", allow=True):
        fused, n = _forward_counts(tn, tp, ts, _t(frame))
        assert n == 1
    np.testing.assert_allclose(fused.numpy(), ref.numpy(), rtol=0, atol=TOL)


def test_auto_mode_fuses_only_at_default_with_f32_activations(rng):
    params = _params(SMALL, rng)
    tp = params_from_jax(params, "cpu")
    ld = layers_dict(SMALL)
    tn = tnet.EventNetwork(ld, 16, 16, leak=0.01, alpha=0.1, padding="SAME",
                           conv_mode="full")
    st = tn.init_state(tp, "cpu")
    frame = _t(rng.rand(1, 16, 16).astype(np.float32))
    with _Tier("highest"):
        ref, n = _forward_counts(tn, tp, st, frame)
        assert n == 0
    with _Tier("default"):
        got, n = _forward_counts(tn, tp, st, frame)
        assert n == 1
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=TOL)
    with _Tier("high"):
        assert _forward_counts(tn, tp, st, frame)[1] == 0
    with _Tier("default", allow=False):
        assert _forward_counts(tn, tp, st, frame)[1] == 0
    bf = tnet.EventNetwork(ld, 16, 16, leak=0.01, alpha=0.1, padding="SAME",
                           conv_mode="full", activation_dtype="bfloat16")
    bf_true = bf.with_stem_fusion(True)
    with _Tier("default"):
        assert _forward_counts(bf, tp, bf.init_state(tp, "cpu"), frame)[1] == 0
        assert _forward_counts(bf_true, tp, bf.init_state(tp, "cpu"), frame)[1] == 1


@pytest.mark.parametrize("batch", [False, True])
def test_full_frame_forward_fused_matches_layerwise_and_jax(rng, batch):
    """The fused forward equals the layer-by-layer one and the JAX fused
    forward, and `upto` cutting inside the pair falls back to the unfused
    ops (no fused call)."""
    params = _params(TWO_PAIRS, rng)
    tp = params_from_jax(params, "cpu")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    kw = dict(leak=0.01, alpha=0.1, padding="SAME", conv_mode="full", stem_fusion=True)
    tn = tnet.EventNetwork(layers_dict(TWO_PAIRS), 16, 16, **kw)
    jn = jnet.EventNetwork(layers_dict(TWO_PAIRS), 16, 16, **kw)
    assert tn._s2d_pairs == jn._s2d_pairs == frozenset({0})
    st, js = tn.init_state(tp, "cpu"), jn.init_state(jp)
    frames = rng.rand(3, 1, 16, 16).astype(np.float32)
    x = _t(frames) if batch else _t(frames[0])
    full, n = _forward_counts(tn, tp, st, x)
    assert n == 1
    layerwise = tn.with_stem_fusion(False)
    ref, n0 = _forward_counts(layerwise, tp, st, x)
    assert n0 == 0
    np.testing.assert_allclose(full.numpy(), ref.numpy(), rtol=0, atol=TOL)
    want = jn.full_frame_forward(jp, js, jnp.asarray(frames[0]))
    np.testing.assert_allclose((full[0] if batch else full).numpy(), np.asarray(want),
                               rtol=0, atol=TOL)
    dense = tnet.dense_forward(tn.event_layers, tp, _t(frames[0]))
    for upto, name, fused_calls in ((1, "conv1", 0), (2, "pool1", 1), (3, "conv2", 1)):
        tap, n = _forward_counts(tn, tp, st, x, upto=upto)
        assert n == fused_calls
        np.testing.assert_allclose((tap[0] if batch else tap).numpy(), dense[name].numpy(),
                                   rtol=0, atol=TOL, err_msg=name)
        jtap = jn.full_frame_forward(jp, js, jnp.asarray(frames[0]), upto=upto)
        np.testing.assert_allclose((tap[0] if batch else tap).numpy(), np.asarray(jtap),
                                   rtol=0, atol=TOL, err_msg=name)


def test_scan_parallel_fused_matches_jax(rng):
    """The whole parallel path with the stem fused at 'highest'
    (stem_fusion=True), port against JAX and against the unfused port."""
    from async_ev_cnn_torch.utils.equivalence import make_stream as tmake
    from async_ev_cnn_tpu.utils.equivalence import make_stream as jmake

    params = _params(TWO_PAIRS, rng)
    tp = params_from_jax(params, "cpu")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    kw = dict(leak=1e-3, alpha=0.1, padding="SAME", conv_mode="full", stem_fusion=True)
    tn = tnet.EventNetwork(layers_dict(TWO_PAIRS), 16, 16, **kw)
    jn = jnet.EventNetwork(layers_dict(TWO_PAIRS), 16, 16, **kw)
    tc = tmake(np.random.RandomState(3), 12, 10, 16, 16, device="cpu")
    jc = jmake(np.random.RandomState(3), 12, 10, 16, 16)
    _, got = tn.scan_parallel(tp, tn.init_state(tp, "cpu"), tc)
    _, want = jn.scan_parallel(jp, jn.init_state(jp), jc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    unfused = tn.with_stem_fusion(False)
    _, ref = unfused.scan_parallel(tp, unfused.init_state(tp, "cpu"), tc)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=TOL)


def test_s2d_tap_table_matches_jax():
    np.testing.assert_array_equal(tstem._DY, jstem._DY)
    # every (a, r, ey) slot maps to a kernel row or the zero slot 3
    assert set(np.unique(tstem._DY)) <= {0, 1, 2, 3}
