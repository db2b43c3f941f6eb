"""The port's mask algebra, composite argmax, rulebook ops and the plain
versions of the K3/K4 rulebook gather-GEMM kernels held against the JAX
package on the same numpy inputs.

Tolerances: the masks, rulebook coordinates and ``composite_argmax`` are
exact (integer and boolean results).  The rulebook products, the plain
kernels against the JAX Pallas kernels (interpret mode, as
tests/test_pallas_rulebook.py runs them) and the scatters of such products
are within 1e-5 absolute (float32 sums of up to kh*kw*C terms taken in
another order).  The CUDA kernels themselves run only on the card, where
chip_smoke.py holds them against these plain versions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from async_ev_cnn_torch.ops import masks as tm
from async_ev_cnn_torch.ops import pool as tpool
from async_ev_cnn_torch.ops import rulebook as trb
from async_ev_cnn_torch.ops import rulebook_gemm as tg
from async_ev_cnn_tpu.ops import masks as jm
from async_ev_cnn_tpu.ops import pool as jpool
from async_ev_cnn_tpu.ops import rulebook as jrb
from async_ev_cnn_tpu.ops.pallas_rulebook import rulebook_gather_gemm_pallas
from async_ev_cnn_tpu.ops.pallas_rulebook_blocks import rulebook_gather_gemm_pallas_blocks

torch.set_num_threads(2)
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _close(got, want, atol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _mask(rng, h, w, p):
    return rng.rand(h, w) < p


@pytest.mark.parametrize("ksize,stride,pads", [
    ((3, 3), 1, ((1, 1), (1, 1))), ((2, 2), 2, ((0, 0), (0, 0))),
    ((1, 1), 1, ((0, 0), (0, 0))), ((3, 2), 2, ((0, 1), (1, 0))),
])
def test_dilate_mask_matches_jax(rng, ksize, stride, pads):
    for p in (0.0, 0.05, 0.5):
        m = _mask(rng, 13, 17, p)
        _eq(tm.dilate_mask(_t(m), ksize, stride, pads),
            jm.dilate_mask(jnp.asarray(m), ksize, stride, pads))


def test_window_view_and_chunk_to_mask_match_jax(rng):
    x = rng.randn(3, 9, 13).astype(np.float32)
    _eq(tm.window_view(_t(x), (2, 2), 2), jm.window_view(jnp.asarray(x), (2, 2), 2))
    for mod in (tm, jm):
        with pytest.raises(NotImplementedError, match="stride == ksize"):
            mod.window_view(x if mod is jm else _t(x), (3, 3), 2)
    # out-of-range, negative and invalid coordinates are dropped
    y = np.array([0, 3, 8, -1, 2, 9, 4, 4], np.int32)
    xx = np.array([0, 5, 12, 3, -2, 1, 13, 6], np.int32)
    valid = np.array([1, 1, 1, 1, 1, 1, 1, 0], bool)
    _eq(tm.chunk_to_mask(_t(y), _t(xx), _t(valid), 9, 13),
        jm.chunk_to_mask(jnp.asarray(y), jnp.asarray(xx), jnp.asarray(valid), 9, 13))


def test_bounding_box_and_coords_match_jax(rng):
    for p in (0.0, 0.01, 0.3, 1.0):
        m = _mask(rng, 11, 21, p)
        for got, want in zip(tm.mask_bounding_box(_t(m)),
                             jm.mask_bounding_box(jnp.asarray(m))):
            _eq(got, want)
        for cap in (1, 8, 40, 231, 500):  # 231 = every site; 500 is capped
            for got, want in zip(tm.mask_to_topk_coords(_t(m), cap),
                                 jm.mask_to_topk_coords(jnp.asarray(m), cap)):
                _eq(got, want)
        for cap in (1, 8, 24, 100):  # 3 blocks a row, the last one ragged
            for got, want in zip(tm.mask_to_block_coords(_t(m), cap, 8),
                                 jm.mask_to_block_coords(jnp.asarray(m), cap, 8)):
                _eq(got, want)


def test_composite_argmax_matches_jax(rng):
    """Small integer values force ties in the max and in the actfn
    tie-break: the lowest index must win, as in the JAX package."""
    s = rng.randint(0, 3, (4, 5, 6, 4)).astype(np.float32)
    a = rng.randint(0, 2, (4, 5, 6, 4)).astype(np.float32)
    for got, want in zip(tpool.composite_argmax(_t(s), _t(a)),
                         jpool.composite_argmax(jnp.asarray(s), jnp.asarray(a))):
        _eq(got, want)


def _planes(rng, c, hp, wp):
    return (rng.randn(c, hp, wp).astype(np.float32),
            rng.randn(c, hp, wp).astype(np.float32))


@pytest.mark.parametrize("stride", [1, 2])
def test_rulebook_conv_pair_and_scatter_match_jax(rng, stride):
    c, o, kh, kw = 3, 5, 3, 3
    hp, wp = 15, 19
    oh, ow = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    fm, ca = _planes(rng, c, hp, wp)
    kern = rng.randn(o, c, kh, kw).astype(np.float32)
    bias = rng.randn(o).astype(np.float32)
    active = _mask(rng, oh, ow, 0.2)
    ys = rng.randint(0, oh, 6).astype(np.int32)
    xs = rng.randint(0, ow, 6).astype(np.int32)
    _eq(trb.patch_indices(_t(ys), _t(xs), stride, (kh, kw), wp),
        jrb.patch_indices(jnp.asarray(ys), jnp.asarray(xs), stride, (kh, kw), wp))
    sp = np.asarray(jrb.patch_indices(jnp.asarray(ys), jnp.asarray(xs), stride,
                                      (kh, kw), wp))
    both = np.stack([fm, ca])
    _eq(trb.gather_patches(_t(both), _t(sp)), jrb.gather_patches(jnp.asarray(both),
                                                                  jnp.asarray(sp)))
    for cap in (8, 100):  # an overflow and a fit
        got = trb.rulebook_conv_pair(_t(fm), _t(ca), _t(active), _t(kern), _t(bias),
                                     stride, cap)
        want = jrb.rulebook_conv_pair(*(jnp.asarray(a) for a in (fm, ca, active, kern,
                                                                  bias)), stride, cap)
        for i in (0, 1, 2, 5):
            _eq(got[i], want[i])
        for i in (3, 4):
            _close(got[i], want[i])
        dest = rng.randn(o, oh, ow).astype(np.float32)
        vals = np.asarray(want[3])
        _eq(trb.scatter_site_values(_t(dest), got[0], got[1], got[2], _t(vals)),
            jrb.scatter_site_values(jnp.asarray(dest), want[0], want[1], want[2],
                                    jnp.asarray(vals)))


@pytest.mark.parametrize("stride,pads", [(1, ((1, 1), (1, 1))), (2, ((0, 1), (0, 1)))])
def test_rows_conv_pair_and_scatter_match_jax(rng, stride, pads):
    c, o, kh, kw = 2, 4, 3, 3
    h, w = 12, 14
    (pt, pb), (pl, pr) = pads
    oh = (h + pt + pb - kh) // stride + 1
    ow = (w + pl + pr - kw) // stride + 1
    fm, ca = _planes(rng, c, h, w)
    kern = rng.randn(o, c, kh, kw).astype(np.float32)
    bias = rng.randn(o).astype(np.float32)
    for p, cap in ((0.05, 4), (0.5, 3), (0.0, 4)):  # fits, overflows, empty
        active = _mask(rng, oh, ow, p)
        got = trb.rows_conv_pair(_t(fm), _t(ca), _t(active), _t(kern), _t(bias),
                                 stride, cap, pads)
        want = jrb.rows_conv_pair(*(jnp.asarray(a) for a in (fm, ca, active, kern, bias)),
                                  stride, cap, pads)
        for i in (0, 1, 4):
            _eq(got[i], want[i])
        for i in (2, 3):
            _close(got[i], want[i])
        dest = rng.randn(o, oh, ow).astype(np.float32)
        vals = np.asarray(want[2])
        _eq(trb.scatter_row_values(_t(dest), got[0], got[1], _t(active), _t(vals)),
            jrb.scatter_row_values(jnp.asarray(dest), want[0], want[1],
                                   jnp.asarray(active), jnp.asarray(vals)))


def _hwc_inputs(rng, hp, wp, c, o, kh, kw):
    fm = rng.randn(hp, wp, c).astype(np.float32)
    ca = rng.randn(hp, wp, c).astype(np.float32)
    kern = rng.randn(kh, kw, c, o).astype(np.float32)
    bias = rng.randn(o).astype(np.float32)
    return fm, ca, kern, bias


def test_k3_plain_matches_pallas_blocks(rng):
    """K = 11 blocks (not a multiple of the JAX tile of 8), including the
    right-edge strip whose columns run past Wp (the JAX package pads the
    planes; the port reads zeros there)."""
    hp, wp, c, o, kh, kw = 9, 22, 3, 5, 3, 3  # ow = 20: 3 blocks, the last ragged
    fm, ca, kern, bias = _hwc_inputs(rng, hp, wp, c, o, kh, kw)
    oh, wb = hp - kh + 1, -(-(wp - kw + 1) // 8)
    by = rng.randint(0, oh, 11).astype(np.int32)
    bx = rng.randint(0, wb, 11).astype(np.int32)
    bx[:3] = wb - 1
    want = rulebook_gather_gemm_pallas_blocks(
        *(jnp.asarray(a) for a in (fm, ca, kern, bias, by, bx)), interpret=True)
    before = dict(tg.LAUNCHES)
    got = tg.rulebook_gather_gemm_blocks(*(_t(a) for a in (fm, ca, kern, bias, by, bx)))
    assert tg.LAUNCHES == before  # CPU tensors: the plain version, no launch
    for g, w_ in zip(got, want):
        _close(g, w_)
    with pytest.raises(NotImplementedError, match="stride 1"):
        tg.rulebook_gather_gemm_blocks(*(_t(a) for a in (fm, ca, kern, bias, by, bx)),
                                       stride=2)


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_k4_plain_matches_pallas_sites(rng, stride):
    hp, wp, c, o, kh, kw = 13, 17, 3, 6, 3, 3
    fm, ca, kern, bias = _hwc_inputs(rng, hp, wp, c, o, kh, kw)
    oh, ow = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    k = 13  # not a multiple of the JAX tile
    ys = rng.randint(0, oh, k).astype(np.int32)
    xs = rng.randint(0, ow, k).astype(np.int32)
    want = rulebook_gather_gemm_pallas(
        *(jnp.asarray(a) for a in (fm, ca, kern, bias, ys, xs)), stride=stride,
        tile=8, interpret=True)
    got = tg.rulebook_gather_gemm(*(_t(a) for a in (fm, ca, kern, bias, ys, xs)),
                                  stride=stride)
    for g, w_ in zip(got, want):
        _close(g, w_)


# (what, hp, wp, C, O, kh, kw, stride, K): K4's edges on the card's
# gather-GEMM (csrc/gather_gemm.cu, per-site map)
K4_EDGES = [
    ("past the last row and column", 11, 14, 4, 8, 3, 3, 2, 40),
    ("stride 3 past the edges", 13, 16, 3, 5, 3, 3, 3, 30),
    ("K = 1", 9, 9, 5, 6, 3, 3, 2, 1),
    ("K past a tile", 17, 19, 4, 7, 3, 3, 2, 33),
    ("C = 1", 12, 15, 1, 16, 3, 3, 2, 21),
    ("O = 110", 7, 9, 24, 110, 1, 1, 2, 17),
]


@pytest.mark.parametrize("what,hp,wp,c,o,kh,kw,stride,k", K4_EDGES,
                         ids=[e[0] for e in K4_EDGES])
def test_k4_plain_matches_pallas_sites_at_the_edges(rng, what, hp, wp, c, o, kh, kw,
                                                    stride, k):
    """Sites up to one past the last output row and column, so boxes run
    past the plane's bottom and right edges: the port reads zeros there,
    and the JAX kernel gets the planes padded with zeros to hold every box
    (as the JAX package's callers pad them)."""
    fm, ca, kern, bias = _hwc_inputs(rng, hp, wp, c, o, kh, kw)
    oh, ow = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    ys = rng.randint(0, oh + 1, k).astype(np.int32)
    xs = rng.randint(0, ow + 1, k).astype(np.int32)
    ys[0], xs[-1] = oh, ow  # one box past the bottom, one past the right
    pad = ((0, kh + stride), (0, kw + stride), (0, 0))
    want = rulebook_gather_gemm_pallas(
        *(jnp.asarray(a) for a in (np.pad(fm, pad), np.pad(ca, pad), kern, bias, ys, xs)),
        stride=stride, tile=8, interpret=True)
    before = dict(tg.LAUNCHES)
    got = tg.rulebook_gather_gemm(*(_t(a) for a in (fm, ca, kern, bias, ys, xs)),
                                  stride=stride)
    assert tg.LAUNCHES == before  # CPU tensors: the plain version, no launch
    for g, w_ in zip(got, want):
        assert tuple(g.shape) == w_.shape == (k, o)
        _close(g, w_)


def test_k3_k4_plain_agree_with_each_other(rng):
    """Without JAX: every site of a block through K4 equals its block row
    through K3, including sites past the right edge (zeros read)."""
    hp, wp, c, o, kh, kw = 7, 12, 4, 3, 3, 3
    fm, ca, kern, bias = (_t(a) for a in _hwc_inputs(rng, hp, wp, c, o, kh, kw))
    by = torch.tensor([0, 4, 2], dtype=torch.int32)
    bx = torch.tensor([0, 1, 1], dtype=torch.int32)
    b_fm, b_ca = tg.rulebook_gather_gemm_blocks(fm, ca, kern, bias, by, bx)
    ys = by.repeat_interleave(8)
    xs = (bx[:, None] * 8 + torch.arange(8, dtype=torch.int32)).reshape(-1)
    s_fm, s_ca = tg.rulebook_gather_gemm(fm, ca, kern, bias, ys, xs)
    _close(b_fm.reshape(-1, o), s_fm)
    _close(b_ca.reshape(-1, o), s_ca)


def test_wrappers_reject_mixed_devices(rng):
    fm, ca, kern, bias = (_t(a) for a in _hwc_inputs(rng, 5, 5, 2, 3, 3, 3))
    ys = torch.zeros(2, dtype=torch.int32)
    meta = torch.empty(2, dtype=torch.int32, device="meta")
    for fn in (tg.rulebook_gather_gemm, tg.rulebook_gather_gemm_blocks):
        with pytest.raises(ValueError, match="all lie on the CPU or all on the card"):
            fn(fm, ca, kern, bias, ys, meta)
