"""The gather-GEMM shared by K3, K4 and K5 (``csrc/gather_gemm.cu``): its
launch plan, and the plain versions at the edges the kernel must take, held
against the JAX package's Pallas kernels (interpret mode, as
``tests/test_pallas_rulebook.py`` and ``tests/test_pallas_rows.py`` run
them on the CPU; K4's edges are in ``tests/test_torch_rulebook.py``).

* The plan (``ops/rulebook_gemm.gather_gemm_plan``) at every eFCN conv
  layer's K3 and K5 shape, at K4's conv2/stride-2 shape and at ragged
  shapes: the tiles cover every
  output site and channel exactly once, the splits partition the
  ``kh*kw*C`` reduction, a block's shared memory fits the H100's 232,448
  bytes, and a split grid fills two blocks per SM as far as whole splits
  allow without passing them, or the splits are at their cap.  The tile
  instances and the three site maps match the CUDA source's.
* The plain versions against ``rulebook_gather_gemm_pallas_blocks`` (K3)
  and ``rows_gather_conv_pallas`` (K5) at O = 110 (no multiple of the
  channel tile), C = 1, ow = 7 (under 32) and K3 blocks at the plane's
  right edge: within 1e-5 absolute (float32 sums of up to kh*kw*C terms in
  another order).

The CUDA kernel runs only on the card, where chip_smoke.py holds it
against these plain versions at the same edges.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from async_ev_cnn_torch.layers.network import build_layer_defs
from async_ev_cnn_torch.ops import rows_gemm as tr
from async_ev_cnn_torch.ops import rulebook_gemm as tg
from async_ev_cnn_torch.utils.config import config
from async_ev_cnn_tpu.ops.pallas_rows import rows_gather_conv_pallas
from async_ev_cnn_tpu.ops.pallas_rulebook_blocks import rulebook_gather_gemm_pallas_blocks

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
SMEM_LIMIT_BYTES = 232_448  # shared memory one block of the H100 may use


def _efcn_shapes():
    """(name, M, O, kh, kw, C) of K3 and K5 at every eFCN conv layer, at the
    sequential path's capacity fraction 0.25: K3 over its block capacity,
    K5 over its row capacity."""
    args = config(["-c", str(REPO / "configs" / "efcn_event.yml")])
    layers, _ = build_layer_defs(args.yolo_cnn_layers, args.frame_h, args.frame_w,
                                 args.leak, 0.1, args.yolo_cnn_padding, "sparse_pallas",
                                 0.25)
    shapes = []
    for ld in layers:
        if ld.kind != "conv":
            continue
        s = ld.spec
        c, (kh, kw), (o, _, ow) = s.in_shape[0], s.ksize, s.out_shape
        shapes.append((f"{ld.name}/K3", s.block_capacity * tg.BLOCK_W, o, kh, kw, c))
        shapes.append((f"{ld.name}/K5", s.row_capacity * ow, o, kh, kw, c))
    return shapes


def _k4_shape():
    """(name, M, O, kh, kw, C) of K4 at conv2's shapes at stride 2, the
    incremental path's stride-2 conv_step (M = that spec's capacity)."""
    args = config(["-c", str(REPO / "configs" / "efcn_event.yml")])
    layers, _ = build_layer_defs(args.yolo_cnn_layers, args.frame_h, args.frame_w,
                                 args.leak, 0.1, args.yolo_cnn_padding, "sparse_pallas",
                                 0.25)
    s = next(ld.spec for ld in layers if ld.name == "conv2")._replace(stride=2)
    return ("conv2/stride2/K4", s.capacity, s.out_shape[0], *s.ksize, s.in_shape[0])


EFCN = _efcn_shapes()
K4_CONV2 = _k4_shape()
RAGGED = [
    ("one site", 1, 1, 1, 1, 1),
    ("C=3 O=5", 88, 5, 3, 3, 3),
    ("O=17", 100, 17, 3, 3, 4),
    ("O=110 ow=7", 35, 110, 1, 1, 512),
    ("M past a tile", 33, 64, 3, 3, 8),
    ("C=1 large M", 17_921, 16, 3, 3, 1),
    ("deep", 40, 300, 3, 3, 1000),
]


def test_efcn_shapes_are_the_layers():
    names = [n for n, *_ in EFCN]
    assert names == [f"conv{i}/{k}" for i in range(1, 8) for k in ("K3", "K5")]
    assert EFCN[0][1:] == (8960, 16, 3, 3, 1)           # conv1: C = 1, O = 16
    assert EFCN[-1][1:] == (35, 110, 1, 1, 512)         # conv7 K5: ow = 7, O = 110


def _split_runs(plan, k_total):
    """The ``[start, end)`` reduction terms of each split, as the kernel
    cuts them (``gather_gemm_kernel``'s ``s_begin``/``s_end``)."""
    n, s, bk = plan.n_slices, plan.splits, plan.block_k
    return [(z * n // s * bk, min((z + 1) * n // s * bk, k_total)) for z in range(s)]


@pytest.mark.parametrize("name,m,o,kh,kw,c", EFCN + [K4_CONV2] + RAGGED,
                         ids=[s[0] for s in EFCN + [K4_CONV2] + RAGGED])
def test_plan_covers_and_splits_exactly(name, m, o, kh, kw, c):
    plan = tg.gather_gemm_plan(m, o, kh, kw, c)
    assert plan.tile == ("narrow" if o <= 16 else "wide")
    sites, block_n, block_k, _ = tg.GATHER_GEMM_TILES[plan.tile]
    assert plan.block_k == block_k
    # every (site, channel) of the output in exactly one tile
    cover = np.zeros((m, o), np.int32)
    for bx in range(plan.grid[0]):
        for by in range(plan.grid[1]):
            cover[bx * sites:(bx + 1) * sites, by * block_n:(by + 1) * block_n] += 1
    assert (cover == 1).all()
    # the splits partition the kh*kw*C reduction into non-empty runs
    k_total = kh * kw * c
    assert plan.n_slices == -(-k_total // block_k)
    runs = _split_runs(plan, k_total)
    assert len(runs) == plan.splits == plan.grid[2]
    assert runs[0][0] == 0 and runs[-1][1] == k_total
    assert all(a < b for a, b in runs)
    assert all(runs[i][1] == runs[i + 1][0] for i in range(len(runs) - 1))
    assert all(a % block_k == 0 for a, _ in runs)
    # the partial sums exist exactly when the reduction is split
    assert plan.workspace == ((plan.splits, 2, m, o) if plan.splits > 1 else None)
    # a block's two-stage ring and site corners fit the H100
    assert plan.smem_bytes + 2 * 4 * sites <= SMEM_LIMIT_BYTES
    # a split grid stays within two blocks per SM and one more split would
    # pass them, or the splits are at their cap
    tiles = plan.grid[0] * plan.grid[1]
    cap = min(plan.n_slices, tg.GATHER_GEMM_MAX_SPLITS)
    if tiles >= tg.GATHER_GEMM_TARGET_BLOCKS:
        assert plan.splits == 1
    else:
        assert tiles * plan.splits <= tg.GATHER_GEMM_TARGET_BLOCKS
        assert tiles * (plan.splits + 1) > tg.GATHER_GEMM_TARGET_BLOCKS or plan.splits == cap


def test_k4_plan_at_conv2_stride2():
    """K4 at conv2's shapes at stride 2: 560 sites, O = 32 on the wide tile
    (half its 64 columns masked), 18 x 1 site tiles, the 144-term
    reduction in five 32-deep slices, one split each."""
    assert K4_CONV2[1:] == (560, 32, 3, 3, 16)
    plan = tg.gather_gemm_plan(*K4_CONV2[1:])
    assert plan.tile == "wide" and plan.block_k == 32 and plan.n_slices == 5
    assert plan.splits == 5 and plan.grid == (18, 1, 5)
    assert plan.workspace == (5, 2, 560, 32)


@pytest.mark.parametrize("want,got", [(1, 1), (5, 5), (0, 1), (1000, 36)])
def test_plan_split_override_is_clamped(want, got):
    """A forced split count stays within one split a slice."""
    plan = tg.gather_gemm_plan(112, 256, 3, 3, 128, splits=want)  # 36 slices
    assert plan.splits == plan.grid[2] == got
    assert plan.workspace == ((got, 2, 112, 256) if got > 1 else None)
    runs = _split_runs(plan, 1152)
    assert runs[0][0] == 0 and runs[-1][1] == 1152 and all(a < b for a, b in runs)


def test_plan_tiles_match_the_cuda_source():
    """The plan's instances and stage size are the kernel's: gather_gemm.cu
    refuses a launch whose shared memory or grid disagrees with its own."""
    src = (REPO / "async_ev_cnn_torch" / "csrc" / "gather_gemm.cu").read_text()
    for tile, cls in (("narrow", "Narrow"), ("wide", "Wide")):
        found = re.search(rf"using {cls} = Tile<(\d+), (\d+), (\d+), (\d+)>;", src)
        assert found is not None
        assert tuple(int(v) for v in found.groups()) == tg.GATHER_GEMM_TILES[tile]
    assert tg.gather_gemm_plan(8960, 16, 3, 3, 1).smem_bytes == 4 * 2 * (128 * 20 + 16 * 16)
    assert tg.gather_gemm_plan(112, 256, 3, 3, 128).smem_bytes == 4 * 2 * (64 * 36 + 32 * 64)
    # the site maps, K4's per-site map among them, are the source's and its
    # C entry launches an instance of each on both tiles
    found = re.search(r"enum class SiteMap \{ kBlocks = (\d+), kRows = (\d+), kSites = (\d+) \};",
                      src)
    assert found is not None
    assert dict(zip(("blocks", "rows", "sites"), map(int, found.groups()))) == tg.SITE_MAPS
    for name, code in (("kBlocks", 0), ("kRows", 1), ("kSites", 2)):
        assert f"case {code}:\n      return launch_map<SiteMap::{name}>" in src
    for tile in ("Narrow", "Wide"):
        for tier in ("true", "false"):
            assert f"launch<{tile}, MAP, {tier}>" in src
    # K4's stride reaches the kernel only through the once-per-block corner
    assert src.count("g.stride") == 2
    assert tg.gather_gemm_plan(*K4_CONV2[1:]).smem_bytes == 4 * 2 * (64 * 36 + 32 * 64)


def _t(a):
    return torch.from_numpy(np.array(a))


def _planes(rng, hp, wp, c, o, kh, kw):
    fm = rng.randn(hp, wp, c).astype(np.float32)
    ca = rng.randn(hp, wp, c).astype(np.float32)
    kern = (rng.randn(kh, kw, c, o) * 0.1).astype(np.float32)
    bias = rng.randn(o).astype(np.float32)
    return fm, ca, kern, bias


# (what, hp, wp, C, O, kh, kw): the padded plane, ow = wp - kw + 1
EDGES = [
    ("O=110 ow=7 (conv7)", 5, 7, 24, 110, 1, 1),
    ("C=1 O=16 ow=7", 8, 9, 1, 16, 3, 3),
    ("C=1 O=16 wide (conv1)", 10, 42, 1, 16, 3, 3),
    ("C=3 O=70 ow=7", 7, 9, 3, 70, 3, 3),
]


@pytest.mark.parametrize("what,hp,wp,c,o,kh,kw", EDGES, ids=[e[0] for e in EDGES])
def test_k3_plain_matches_pallas_blocks_at_the_edges(rng, what, hp, wp, c, o, kh, kw):
    """Every block of the map, the right-edge ones included: their sites
    past ow (and their reads past Wp) are computed, as the JAX kernel's
    padded planes give them."""
    fm, ca, kern, bias = _planes(rng, hp, wp, c, o, kh, kw)
    oh, wb = hp - kh + 1, -(-(wp - kw + 1) // tg.BLOCK_W)
    by = np.repeat(np.arange(oh), wb).astype(np.int32)
    bx = np.tile(np.arange(wb), oh).astype(np.int32)
    want = rulebook_gather_gemm_pallas_blocks(
        *(jnp.asarray(a) for a in (fm, ca, kern, bias, by, bx)), interpret=True)
    before = dict(tg.LAUNCHES)
    got = tg.rulebook_gather_gemm_blocks(*(_t(a) for a in (fm, ca, kern, bias, by, bx)))
    assert tg.LAUNCHES == before  # CPU tensors: the plain version, no launch
    for g, w_ in zip(got, want):
        assert tuple(g.shape) == w_.shape == (len(by), tg.BLOCK_W, o)
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=0, atol=1e-5)


@pytest.mark.parametrize("what,hp,wp,c,o,kh,kw", EDGES, ids=[e[0] for e in EDGES])
def test_k5_plain_matches_pallas_rows_at_the_edges(rng, what, hp, wp, c, o, kh, kw):
    """Rows in any order, repeated, and the last row of the plane; the
    output is exactly [R, ow, O], no strip columns."""
    fm, ca, kern, bias = _planes(rng, hp, wp, c, o, kh, kw)
    oh, ow = hp - kh + 1, wp - kw + 1
    rows = np.array([oh - 1, 0, oh // 2, oh - 1], np.int32)
    want = rows_gather_conv_pallas(*(jnp.asarray(a) for a in (fm, ca, kern, bias, rows)),
                                   interpret=True)
    before = dict(tr.LAUNCHES)
    got = tr.rows_gather_conv(*(_t(a) for a in (fm, ca, kern, bias, rows)))
    assert tr.LAUNCHES == before
    for g, w_ in zip(got, want):
        assert tuple(g.shape) == w_.shape == (len(rows), ow, o)
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=0, atol=1e-5)
