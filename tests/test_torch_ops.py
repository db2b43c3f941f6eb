"""The port's primitive ops (async_ev_cnn_torch/ops) held against the JAX
package on the same numpy inputs.

Tolerances: ``snap``, the pad/shape formulas, ``leaky``, ``leaky_mask``
and ``maxpool_dense`` are exact (the same IEEE float32 operations);
``conv2d_dense`` is within 1e-5 absolute (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from async_ev_cnn_torch.ops import conv as tconv
from async_ev_cnn_torch.ops import masks as tmasks
from async_ev_cnn_torch.ops import numerics as tnum
from async_ev_cnn_torch.ops import pool as tpool
from async_ev_cnn_tpu.ops import conv as jconv
from async_ev_cnn_tpu.ops import masks as jmasks
from async_ev_cnn_tpu.ops import numerics as jnum
from async_ev_cnn_tpu.ops import pool as jpool

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_snap_bit_exact_including_half_ties(rng):
    """torch.round rounds half to even like jnp.round: values placed
    exactly on grid half-points must land on the same neighbour."""
    x = (rng.randn(4096) * 3).astype(np.float32)
    halves = ((np.arange(-64, 64) + 0.5) * 2.0**-20).astype(np.float32)
    x = np.concatenate([x, halves, np.float32([0.0, -0.0, 1e-30, -1e-30])])
    got = tnum.snap(_t(x)).numpy()
    want = np.asarray(jnum.snap(jnp.asarray(x)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert tnum.SNAP_BITS == jnum.SNAP_BITS


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_pads_and_out_shapes_match(padding, stride, k):
    for in_h, in_w in ((7, 9), (8, 8), (13, 6), (160, 224)):
        args = (in_h, in_w, k, k + 1 if k > 1 else k, stride)
        assert tconv.tf_same_pads(*args) == jconv.tf_same_pads(*args)
        assert tconv.conv_pads(*args, padding) == jconv.conv_pads(*args, padding)
        assert tconv.conv_out_shape(*args, padding) == jconv.conv_out_shape(*args, padding)
        assert tmasks.pool_out_shape(in_h, in_w, (k, k), stride) == \
            jmasks.pool_out_shape(in_h, in_w, (k, k), stride)


def test_bad_padding_rejected():
    with pytest.raises(ValueError, match="padding"):
        tconv.conv_pads(8, 8, 3, 3, 1, "FULL")
    with pytest.raises(ValueError, match="padding"):
        tconv.conv_out_shape(8, 8, 3, 3, 1, "FULL")


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("batched", [False, True])
def test_conv2d_dense_matches_jax(rng, padding, stride, batched):
    """Odd sizes make SAME's pads asymmetric at stride 2 (the F.pad leg);
    stride 1 with a 3x3 kernel takes the symmetric leg."""
    x = rng.randn(*((3,) if batched else ()), 4, 11, 13).astype(np.float32)
    for kh, kw in ((3, 3), (2, 4), (1, 1)):
        k_oihw = (rng.randn(6, 4, kh, kw) * 0.3).astype(np.float32)
        b = rng.randn(6).astype(np.float32)
        got = tconv.conv2d_dense(_t(x), _t(k_oihw), _t(b), stride, padding)
        want = jconv.conv2d_dense(jnp.asarray(x), jnp.asarray(k_oihw),
                                  jnp.asarray(b), stride, padding)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_leaky_and_mask_exact(rng):
    x = rng.randn(5, 7, 9).astype(np.float32)
    x[0, 0, :3] = [0.0, -0.0, 1e-30]
    for alpha in (0.1, 0.3333):
        got = tconv.leaky(_t(x), alpha).numpy()
        want = np.asarray(jconv.leaky(jnp.asarray(x), alpha))
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        np.testing.assert_array_equal(
            tconv.leaky_mask(_t(x), alpha).numpy(),
            np.asarray(jconv.leaky_mask(jnp.asarray(x), alpha)))


def test_leaky_under_autograd_matches_jax_grad(rng):
    """Under autograd leaky stays out of place: the same bits as the
    in-place call, and the gradient of JAX's leaky (ties at 0 included)."""
    import jax

    x = rng.randn(4, 6, 8).astype(np.float32)
    x[0, 0, :2] = [0.0, -0.0]
    g = rng.randn(*x.shape).astype(np.float32)
    tx = _t(x).requires_grad_(True)
    y = tconv.leaky(tx, 0.1)
    assert y.requires_grad
    np.testing.assert_array_equal(y.detach().numpy().view(np.int32),
                                  tconv.leaky(_t(x), 0.1).numpy().view(np.int32))
    (y * _t(g)).sum().backward()
    want = jax.grad(lambda v: (jconv.leaky(v, 0.1) * g).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want))


def _pool_input(rng, shape, dtype):
    if dtype == "bool":
        return rng.rand(*shape) < 0.2
    if dtype == "int32":
        # the extremes too: SAME pads with the type's least value
        x = rng.randint(-50, 50, shape).astype(np.int32)
        x.flat[0], x.flat[-1] = np.iinfo(np.int32).min, np.iinfo(np.int32).max
        return x
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bool"])
@pytest.mark.parametrize("ksize,stride", [((2, 2), 2), ((3, 3), 3), ((2, 2), 1),
                                          ((3, 2), 2)])
def test_maxpool_dense_exact(rng, ksize, stride, dtype, padding):
    """Float32, int32 and bool (the window-wise OR), VALID and TF SAME
    (asymmetric pads where the windows overhang the ragged edge), 3-D and
    4-D: equal to the JAX op element for element, dtype and shape too."""
    for shape in ((4, 9, 11), (2, 3, 8, 8), (1, 7, 13)):
        x = _pool_input(rng, shape, dtype)
        got = tpool.maxpool_dense(_t(x), ksize, stride, padding)
        want = np.asarray(jpool.maxpool_dense(jnp.asarray(x), ksize, stride, padding))
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_matmul_tier_turns_tf32_off():
    """'highest' is IEEE float32 in cuDNN and cuBLAS: both TF32 flags off
    (cuDNN's default is on).  'high' is IEEE float32 too; 'default' turns
    TF32 on in both (tests/test_torch_tiers.py has the rest)."""
    torch.backends.cudnn.allow_tf32 = True
    try:
        tconv.set_matmul_precision("highest")
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert tconv.matmul_precision() == "highest"
        for tier, tf32 in (("high", False), ("default", True)):
            tconv.set_matmul_precision(tier)
            assert tconv.matmul_precision() == tier
            assert torch.backends.cudnn.allow_tf32 is tf32
            assert torch.backends.cuda.matmul.allow_tf32 is tf32
        tconv.set_matmul_precision("highest")
        assert torch.backends.cudnn.allow_tf32 is False
        with pytest.raises(ValueError, match="one of"):
            tconv.set_matmul_precision("fast")
    finally:
        tconv.set_matmul_precision("highest")


def test_layer_types_and_chunk_from_arrays(rng):
    from async_ev_cnn_torch.layers.types import EventChunk, LayerIO, validate_int32_ts
    from async_ev_cnn_tpu.layers.types import EventChunk as JChunk
    from async_ev_cnn_tpu.layers.types import validate_int32_ts as jvalidate

    y, x = rng.randint(0, 9, 5), rng.randint(0, 9, 5)
    ts, p = np.arange(5) * 3, rng.randint(0, 2, 5)
    got = EventChunk.from_arrays(y, x, ts, p, capacity=8, device="cpu")
    want = JChunk.from_arrays(y, x, ts, p, capacity=8)
    assert got.capacity == want.capacity == 8
    for g, w in zip(got, want):
        assert g.dtype == (torch.bool if w.dtype == bool else torch.int32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for bad in (np.array([-1, 3]), np.array([0, 2**31])):
        with pytest.raises(ValueError) as e_t:
            validate_int32_ts(bad)
        with pytest.raises(ValueError) as e_j:
            jvalidate(bad)
        assert str(e_t.value) == str(e_j.value)
    with pytest.raises(ValueError, match="capacity"):
        EventChunk.from_arrays(y, x, ts, capacity=2, device="cpu")

    s = _t(rng.randn(2, 3, 4).astype(np.float32))
    a = _t(rng.rand(2, 3, 4).astype(np.float32))
    assert torch.equal(LayerIO(s, a, None, None).featuremap, s * a)
    assert LayerIO(s, None, None, None).featuremap is s


def test_config_and_layer_dsl_match_jax():
    """The copied config parser reads the shipped eFCN config, the layer
    DSL with @mode tags, and flag overrides exactly as the JAX package."""
    from importlib import import_module
    from pathlib import Path

    # import_module: the JAX package's utils/__init__ re-exports the
    # config() function under the module's name
    tcfg = import_module("async_ev_cnn_torch.utils.config")
    jcfg = import_module("async_ev_cnn_tpu.utils.config")

    yml = str(Path(__file__).resolve().parent.parent / "configs" / "efcn_event.yml")
    for argv in (["-c", yml], ["-c", yml, "--leak", "1e-4", "--mode", "full"]):
        got, want = vars(tcfg.config(argv)), vars(jcfg.config(argv))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == want[k], k
    text = "conv1=3,3,1,16@window pool1=2,2 conv2=1,1,16,8@full"
    got, want = tcfg.layers_dict(text), jcfg.layers_dict(text)
    assert list(got.items()) == list(want.items()) and got.modes == want.modes
    assert tcfg.layers_dsl(got) == jcfg.layers_dsl(want) == text
