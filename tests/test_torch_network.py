"""The port's network assembly (async_ev_cnn_torch/layers) held against the
JAX package on a narrow eFCN-shaped net: 32x48, conv1..conv3 with two
pools, widths <= 16, random weights from a seed.

Tolerances: surfaces and ``prev_ts`` bit for bit (both sides run the
event-scatter engine: the JAX Pallas kernel in interpret mode, the port's
plain version); network outputs and per-layer dense maps within 1e-4
absolute (float32 convs whose sums run in another order), the contract of
tests/test_equivalence.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from async_ev_cnn_torch.layers import network as tnet
from async_ev_cnn_torch.layers.types import EventChunk as TChunk
from async_ev_cnn_torch.utils.weights import params_from_jax
from async_ev_cnn_tpu.layers import network as jnet
from async_ev_cnn_tpu.layers.types import EventChunk as JChunk
from async_ev_cnn_tpu.utils.config import layers_dict

torch.set_num_threads(2)

H, W = 32, 48
DSL = "conv1=3,3,1,8 pool1=2,2 conv2=3,3,8,16 pool2=2,2 conv3=1,1,16,12"
DSL2 = "conv1=3,3,2,6 pool1=2,2 conv2=3,3,6,10"
EFCN = ("conv1=3,3,1,16 pool1=2,2 conv2=3,3,16,32 pool2=2,2 conv3=3,3,32,64 "
        "pool3=2,2 conv4=3,3,64,128 pool4=2,2 conv5=3,3,128,256 pool5=2,2 "
        "conv6=1,1,256,512 conv7=1,1,512,110")
TOL = 1e-4


def _params(layer_defs, rng, scale=0.2):
    out = {}
    for name, size in layer_defs.items():
        if "conv" in name:
            out[f"w_{name}"] = (rng.randn(*size[:2], size[2], size[3]) * scale).astype(np.float32)
            out[f"b_{name}"] = (rng.randn(size[3]) * scale).astype(np.float32)
    return out


def _chunks(rng, t, e, occupancy=0.8):
    ts = np.cumsum(rng.randint(1, 40, t * e)).astype(np.int32).reshape(t, e)
    arrays = (rng.randint(0, H, (t, e)), rng.randint(0, W, (t, e)), ts,
              rng.randint(0, 2, (t, e)), rng.rand(t, e) < occupancy)
    arrays = [a.astype(np.int32) if a.dtype != bool else a for a in arrays]
    return (TChunk(*(torch.from_numpy(a) for a in arrays)),
            JChunk(*(jnp.asarray(a) for a in arrays)))


def _nets(dsl, **kw):
    ld = layers_dict(dsl)
    args = (ld, H, W)
    kw = dict(leak=2e-3, alpha=0.1, padding="SAME", conv_mode="full", **kw)
    return ld, tnet.EventNetwork(*args, **kw), jnet.EventNetwork(*args, **kw)


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("dsl", [DSL, DSL2])
def test_scan_parallel_matches_jax(rng, dsl):
    """Without a window, with one that divides T and with one that does not
    (the port runs a shorter last window; the JAX package pads with no-op
    chunks)."""
    ld, tn, jn = _nets(dsl)
    params = _params(ld, rng)
    tp = params_from_jax(params, "cpu")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tc, jc = _chunks(rng, 10, 16)
    t_state, j_state = tn.init_state(tp, "cpu"), jn.init_state(jp)
    j_st, j_out = jn.scan_parallel(jp, j_state, jc, integrate_engine="pallas")
    for window in (None, 5, 4):
        t_st, t_out = tn.scan_parallel(tp, t_state, tc, window=window)
        np.testing.assert_array_equal(_bits(t_st[0].surface), _bits(j_st[0].surface))
        assert int(t_st[0].prev_ts) == int(j_st[0].prev_ts)
        assert tuple(t_out.shape) == j_out.shape
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0, atol=TOL)
    # the JAX package's own windowed run, including the padded tail
    j_st4, j_out4 = jn.scan_parallel(jp, j_state, jc, window=4, integrate_engine="pallas")
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out4), rtol=0, atol=TOL)
    np.testing.assert_array_equal(_bits(t_st[0].surface), _bits(j_st4[0].surface))
    # the ts-map engine (the JAX 'pallas_tsmap') gives the same surfaces
    t_stm, t_outm = tn.scan_parallel(tp, t_state, tc, integrate_engine="tsmap")
    np.testing.assert_array_equal(_bits(t_stm[0].surface), _bits(j_st[0].surface))
    np.testing.assert_allclose(t_outm.numpy(), np.asarray(j_out), rtol=0, atol=TOL)


def test_scan_parallel_chains_across_calls(rng):
    """Two consecutive calls carry the surface and prev_ts exactly as one
    call over the concatenated chunks."""
    ld, tn, _ = _nets(DSL)
    tp = params_from_jax(_params(ld, rng), "cpu")
    tc, _ = _chunks(rng, 8, 12)
    st = tn.init_state(tp, "cpu")
    st_all, out_all = tn.scan_parallel(tp, st, tc)
    st_a, out_a = tn.scan_parallel(tp, st, TChunk(*(f[:3] for f in tc)))
    st_b, out_b = tn.scan_parallel(tp, st_a, TChunk(*(f[3:] for f in tc)))
    np.testing.assert_array_equal(_bits(st_b[0].surface), _bits(st_all[0].surface))
    assert int(st_b[0].prev_ts) == int(st_all[0].prev_ts)
    np.testing.assert_allclose(torch.cat([out_a, out_b]).numpy(), out_all.numpy(),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("variant", ["tf", "numpy"])
def test_dense_forward_and_frame_forward_match_jax(rng, variant):
    ld, tn, jn = _nets(DSL)
    params = _params(ld, rng)
    tp = params_from_jax(params, "cpu")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    frame = rng.rand(1, H, W).astype(np.float32)
    got = tnet.dense_forward(tn.event_layers, tp, torch.from_numpy(frame), variant)
    want = jnet.dense_forward(jn.event_layers, jp, jnp.asarray(frame), variant)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=0, atol=TOL, err_msg=name)
    t_state, j_state = tn.init_state(tp, "cpu"), jn.init_state(jp)
    for upto in (None, 1, 3):
        g = tn.full_frame_forward(tp, t_state, torch.from_numpy(frame), upto=upto)
        wv = jn.full_frame_forward(jp, j_state, jnp.asarray(frame), upto=upto)
        assert tuple(g.shape) == wv.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=0, atol=TOL)


def test_memory_model_matches_jax():
    for dsl, h, w in ((EFCN, 160, 224), (DSL, H, W)):
        ld = layers_dict(dsl)
        tn = tnet.EventNetwork(ld, h, w, 5e-5, padding="SAME", conv_mode="full")
        jn = jnet.EventNetwork(ld, h, w, 5e-5, padding="SAME", conv_mode="full")
        assert tn.parallel_live_bytes_per_chunk() == jn.parallel_live_bytes_per_chunk()
        for t in (1, 7, 64, 200, 5000):
            for budget in (1, 16, 100, 512, 4096):
                assert tn.auto_window(t, budget) == jn.auto_window(t, budget)
        assert tn.out_shape == jn.out_shape
        assert tn.is_all_full and jn.is_all_full


def test_build_layer_defs_match_jax():
    """The same specs field for field, including per-layer @mode tags and
    the coercion of layers after a 'full' one; and the same errors."""
    for dsl, mode in ((EFCN, "auto"), (DSL, "dense"),
                      ("conv1=3,3,1,4@sparse pool1=2,2 conv2=3,3,4,8@full "
                       "conv3=1,1,8,8 flatten1= fc1=10,5", "window")):
        args = (layers_dict(dsl), 40, 56, 1e-3, 0.1, "SAME", mode)
        t_ev, t_tail = tnet.build_layer_defs(*args)
        j_ev, j_tail = jnet.build_layer_defs(*args)
        assert [tuple(ld) for ld in t_ev] == [tuple(ld) for ld in j_ev]
        assert [tuple(ld) for ld in t_tail] == [tuple(ld) for ld in j_tail]
    for dsl, mode, match in ((DSL, "fancy", "conv_mode"),
                             ("conv1=3,3,1,4 conv2=3,3,5,8", "full", "in_channels"),
                             ("conv1=3,3,3,4", "full", "surface channels"),
                             ("conv1=3,3,1,4@full conv2=3,3,4,4@dense", "dense",
                              "cannot follow"),
                             ("conv1=3,3,1,4 relu1=1", "full", "unknown layer")):
        for mod in (tnet, jnet):
            with pytest.raises(ValueError, match=match):
                mod.build_layer_defs(layers_dict(dsl), 16, 16, 1e-3, 0.1, "SAME", mode)


def test_slice_limits_raise_not_implemented(rng):
    """The limits the port keeps: an incremental net has no parallel-in-time
    path, and bad option values raise.  bf16 activations and stem fusion,
    which earlier slices refused, are carried now (tests/test_torch_tiers.py
    and tests/test_torch_stem.py); the incremental modes too
    (tests/test_torch_incremental.py)."""
    ld = layers_dict(DSL)
    tp = params_from_jax(_params(ld, rng), "cpu")
    dense = tnet.EventNetwork(ld, H, W, 1e-3, padding="SAME", conv_mode="dense")
    assert not dense.is_all_full
    st = dense.init_state(tp, "cpu")
    assert tuple(st[1].featuremap.shape) == dense.event_layers[1].spec.out_shape
    bf16 = tnet.EventNetwork(ld, H, W, 1e-3, conv_mode="full", activation_dtype="bfloat16")
    assert bf16.event_layers[1].spec.act_dtype == "bfloat16"
    with pytest.raises(ValueError, match="activation_dtype"):
        tnet.EventNetwork(ld, H, W, 1e-3, conv_mode="full", activation_dtype="float16")
    fused = tnet.EventNetwork(ld, H, W, 1e-3, padding="SAME", conv_mode="full",
                              stem_fusion=True)
    assert fused._s2d_pairs == frozenset({0}) and fused._fusion_active()
    net = tnet.EventNetwork(ld, H, W, 1e-3, padding="SAME", conv_mode="full")
    assert net.with_stem_fusion(False)._stem_fusion is False
    assert net.with_stem_fusion(True)._fusion_active()
    with pytest.raises(ValueError, match="stem_fusion"):
        net.with_stem_fusion(1)
    tc, _ = _chunks(rng, 2, 4)
    with pytest.raises(ValueError, match="conv_mode='full'"):
        dense.scan_parallel(tp, st, tc)


def test_params_from_jax_layout(rng):
    """HWIO conv kernels become OIHW; biases and 2-D fc weights pass
    unchanged; values and dtypes are kept."""
    ld = layers_dict(DSL)
    params = _params(ld, rng)
    params["w_fc1"] = rng.randn(12, 5).astype(np.float32)
    params["b_fc1"] = rng.randn(5).astype(np.float32)
    got = params_from_jax(params, "cpu")
    assert set(got) == set(params)
    for k, v in params.items():
        want = v.transpose(3, 2, 0, 1) if (k.startswith("w_") and v.ndim == 4) else v
        assert got[k].dtype == torch.float32 and got[k].is_contiguous()
        np.testing.assert_array_equal(got[k].numpy(), want)


def test_apply_tail_fc_matches_jax(rng):
    """The dense fc/flatten tail on one frame and on a batch."""
    ld = layers_dict("conv1=3,3,1,4 pool1=2,2 flatten1= fc1=96,7")
    tn = tnet.EventNetwork(ld, 8, 12, 1e-3, padding="SAME", conv_mode="full")
    jn = jnet.EventNetwork(ld, 8, 12, 1e-3, padding="SAME", conv_mode="full")
    params = _params(ld, rng)
    params["w_fc1"] = rng.randn(96, 7).astype(np.float32)
    params["b_fc1"] = rng.randn(7).astype(np.float32)
    fm = rng.randn(3, 4, 6, 4).astype(np.float32)
    tp = params_from_jax(params, "cpu")
    batched = tn.apply_tail(tp, torch.from_numpy(fm))
    for i in range(3):
        want = jn.apply_tail({k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(fm[i]))
        np.testing.assert_allclose(tn.apply_tail(tp, torch.from_numpy(fm[i])).numpy(),
                                   np.asarray(want), rtol=0, atol=TOL)
        np.testing.assert_allclose(batched[i].numpy(), np.asarray(want), rtol=0, atol=TOL)
