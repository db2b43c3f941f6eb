"""The plain versions of the port's last three kernels held against the JAX
package's Pallas kernels (interpret mode, as the JAX package's own tests
and examples run them on the CPU):

* K5 ``ops/rows_gemm.rows_gather_conv`` against
  ``async_ev_cnn_tpu/ops/pallas_rows.rows_gather_conv_pallas`` and, through
  ``kernel_rows_conv_pair``, against the port's and the JAX package's
  ``rows_conv_pair``: within 1e-5 absolute (float32 sums of up to
  kh*kw*C terms in another order);
* K6 ``ops/fused_stem.fused_stem`` against
  ``examples/pallas_stem_negative.fused_stem``: within 1e-6 absolute (the
  same nine multiply-adds a pixel; XLA on the CPU may contract a multiply
  and an add into one FMA), and within 1e-5 of ``fused_conv_pool`` and of
  the direct conv -> leaky -> pool;
* K7 ``scripts/dma_microbench.run`` against
  ``examples/dma_microbench.run`` for every shape and kh at grid 4 and 2
  copies: bit for bit (the same rows added in the same order).

The examples are loaded from their paths.  The CUDA kernels run only on
the card, where chip_smoke.py holds them against these plain versions.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from async_ev_cnn_torch.ops import conv as tconv
from async_ev_cnn_torch.ops import fused_stem as tf
from async_ev_cnn_torch.ops import pool as tpool
from async_ev_cnn_torch.ops import rows_gemm as tr
from async_ev_cnn_torch.ops import rulebook as trb
from async_ev_cnn_torch.ops import stem as tstem
from async_ev_cnn_torch.scripts import dma_microbench as tdma
from async_ev_cnn_tpu.ops import rulebook as jrb
from async_ev_cnn_tpu.ops.pallas_rows import rows_gather_conv_pallas

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent


def _example(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("h,w,c,o,kh,kw,rows", [
    (24, 20, 5, 7, 3, 3, [0, 3, 7, 20]),
    (10, 14, 40, 35, 3, 3, [9, 0, 4]),      # O past one 32-channel tile
    (5, 7, 24, 11, 1, 1, [0, 1, 2, 3, 4]),  # 1x1, as conv6/conv7
    (12, 70, 2, 16, 3, 3, [5, 11]),         # ow past two 32-column tiles
])
def test_k5_plain_matches_pallas_rows(rng, h, w, c, o, kh, kw, rows):
    hp, wp = h + kh - 1, w + kw - 1
    fm = rng.rand(hp, wp, c).astype(np.float32)
    ca = rng.rand(hp, wp, c).astype(np.float32)
    k = (rng.randn(kh, kw, c, o) * 0.1).astype(np.float32)
    b = (rng.randn(o) * 0.1).astype(np.float32)
    r = np.asarray(rows, np.int32)
    want = rows_gather_conv_pallas(*(jnp.asarray(a) for a in (fm, ca, k, b, r)),
                                   interpret=True)
    before = dict(tr.LAUNCHES)
    got = tr.rows_gather_conv(*(_t(a) for a in (fm, ca, k, b, r)))
    assert tr.LAUNCHES == before  # CPU tensors: the plain version, no launch
    for g, w_ in zip(got, want):
        assert tuple(g.shape) == w_.shape == (len(rows), w, o)
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=0, atol=1e-5)


@pytest.mark.parametrize("p,cap", [(0.05, 4), (0.5, 3), (0.0, 4), (0.2, 12)])
def test_k5_rows_conv_pair_matches_rulebook_and_jax(rng, p, cap):
    """The K5 route of the 'sparse_rows' update gives rows_conv_pair's rows
    (port and JAX), including overflow and an empty mask."""
    c, o, h, w = 3, 6, 12, 14
    pads = ((1, 1), (1, 1))
    fm, ca = (rng.randn(c, h, w).astype(np.float32) for _ in range(2))
    kern = rng.randn(o, c, 3, 3).astype(np.float32)
    bias = rng.randn(o).astype(np.float32)
    active = rng.rand(h, w) < p
    got = tr.kernel_rows_conv_pair(*(_t(a) for a in (fm, ca, active, kern, bias)), cap, pads)
    ref = trb.rows_conv_pair(*(_t(a) for a in (fm, ca, active, kern, bias)), 1, cap, pads)
    want = jrb.rows_conv_pair(*(jnp.asarray(a) for a in (fm, ca, active, kern, bias)),
                              1, cap, pads)
    for i in (0, 1, 4):
        assert torch.equal(got[i], ref[i])
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    for i in (2, 3):
        np.testing.assert_allclose(got[i].numpy(), ref[i].numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=0, atol=1e-5)


def test_k5_checks_inputs(rng):
    fm = _t(rng.rand(6, 6, 2).astype(np.float32))
    k = _t(rng.rand(3, 3, 2, 4).astype(np.float32))
    b = _t(rng.rand(4).astype(np.float32))
    meta = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="all lie on the CPU or all on the card"):
        tr.rows_gather_conv(fm, fm, k, b, meta)
    out = tr.rows_gather_conv(fm, fm, k, b, torch.zeros(0, dtype=torch.int32))
    assert tuple(out[0].shape) == (0, 4, 4)


@pytest.mark.parametrize("t,h,w,o", [
    (2, 16, 24, 4),
    (3, 18, 14, 1),    # O = 1; H/2 = 9, W/2 = 7 odd
    (1, 22, 30, 32),   # O = 32; H/2 = 11, W/2 = 15 odd
])
def test_k6_plain_matches_example(rng, t, h, w, o):
    psn = _example("pallas_stem_negative")
    x = rng.rand(t, h, w).astype(np.float32)
    k = (rng.randn(o, 1, 3, 3) * 0.3).astype(np.float32)
    b = (rng.randn(o) * 0.1).astype(np.float32)
    taps = tf.w_taps_from_oihw(_t(k))
    want_taps = jnp.transpose(jnp.asarray(k)[:, 0], (1, 2, 0)).reshape(9, o)  # the example's :101
    np.testing.assert_array_equal(taps.numpy(), np.asarray(want_taps))
    before = dict(tf.LAUNCHES)
    got = tf.fused_stem(_t(x), taps, _t(b), 0.1)
    assert tf.LAUNCHES == before
    want = psn.fused_stem(jnp.asarray(x), want_taps, jnp.asarray(b), 0.1, interpret=True)
    assert tuple(got.shape) == want.shape == (t, o, h // 2, w // 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # the library stems: s2d fused pair, and the direct conv -> leaky -> pool
    fused = tstem.fused_conv_pool(_t(x)[:, None], _t(k), _t(b), 0.1)
    direct = tpool.maxpool_dense(tconv.leaky(
        tconv.conv2d_dense(_t(x)[:, None], _t(k), _t(b), 1, "SAME"), 0.1), (2, 2), 2)
    np.testing.assert_allclose(got.numpy(), fused.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=0, atol=1e-5)


def test_k6_rejects_what_it_does_not_take(rng):
    with pytest.raises(ValueError, match=r"\[O, 1, 3, 3\]"):
        tf.w_taps_from_oihw(_t(rng.rand(4, 2, 3, 3).astype(np.float32)))
    taps = _t(rng.rand(9, 4).astype(np.float32))
    b = _t(rng.rand(4).astype(np.float32))
    for shape in ((2, 15, 8), (2, 1, 8, 8)):
        with pytest.raises(ValueError, match="even H and W"):
            tf.fused_stem(_t(rng.rand(*shape).astype(np.float32)), taps, b)
    # O past the kernel's parameter struct, or none: refused on either route
    x = _t(rng.rand(1, 4, 4).astype(np.float32))
    for o in (tf.STEM_MAX_O + 1, 0):
        with pytest.raises(ValueError, match=f"1 <= O <= {tf.STEM_MAX_O}"):
            tf.fused_stem(x, _t(rng.rand(9, o).astype(np.float32)),
                          _t(rng.rand(o).astype(np.float32)))
    out = tf.fused_stem(x, _t(rng.rand(9, tf.STEM_MAX_O).astype(np.float32)),
                        _t(rng.rand(tf.STEM_MAX_O).astype(np.float32)))
    assert tuple(out.shape) == (1, tf.STEM_MAX_O, 2, 2)


def test_k6_constants_match_the_cuda_source():
    """The wrapper's largest O is the kernel's parameter struct's, and at the
    eFCN's width a tile's items (2x2 pooled pixels each: half the band's
    rows, a pair of columns) are exactly the block's threads."""
    src = (REPO / "async_ev_cnn_torch" / "csrc" / "fused_stem.cu").read_text()

    def constant(name):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found is not None, name
        return int(found.group(1))

    assert constant("kMaxO") == tf.STEM_MAX_O
    assert constant("kBand") // 2 * (224 // 4) == constant("kThreads")


@pytest.fixture(scope="module")
def dma_inputs():
    src, flat, ys, xs = tdma.make_inputs(0, "cpu")
    return (src, flat, ys, xs), tuple(jnp.asarray(a.numpy()) for a in (src, flat, ys, xs))


@pytest.mark.parametrize("shape", tdma.SHAPES)
def test_k7_plain_matches_example(dma_inputs, shape):
    dmb = _example("dma_microbench")
    assert (dmb.H, dmb.W, dmb.C, dmb.KH, dmb.WCOPY, dmb.N_SITES) == (
        tdma.H, tdma.W, tdma.C, tdma.KH, tdma.WCOPY, tdma.N_SITES)
    t_in, j_in = dma_inputs
    for kh in (3, 8):
        before = dict(tdma.LAUNCHES)
        got = tdma.run(*t_in, 4, 2, shape, kh)
        assert tdma.LAUNCHES == before
        want = dmb.run(*j_in, 4, 2, shape, kh, interpret=True)
        assert tuple(got.shape) == want.shape == (1, tdma.C)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tdma.copy_bytes(shape, 3) == 3 * (8 if shape == "box_sm" else 32) * 128 * 4


def test_k7_cli_on_the_cpu(capsys):
    assert tdma.main(["--device", "cpu"]) == 0
    assert "semantics OK" in capsys.readouterr().out
    with pytest.raises(ValueError, match="shape must be one of"):
        tdma.run(*(torch.zeros(1) for _ in range(4)), 1, 1, "diagonal")
