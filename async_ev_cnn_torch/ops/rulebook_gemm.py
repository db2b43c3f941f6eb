"""Rulebook gather-GEMM kernels of the 'sparse_pallas' conv mode.

Counterpart of ``async_ev_cnn_tpu/ops/pallas_rulebook_blocks.py`` and
``async_ev_cnn_tpu/ops/pallas_rulebook.py``.  Two functions, each with a
hand-written CUDA kernel and a plain PyTorch version of the same
arithmetic; both take the JAX signatures' layouts: padded HWC
``[Hp, Wp, C]`` featuremap and conv-actfn planes, an HWIO ``[kh, kw, C, O]``
kernel, a ``[O]`` bias (added to the featuremap plane only) and int32
``[K]`` coordinates.

* :func:`rulebook_gather_gemm_blocks` (K3, JAX
  ``rulebook_gather_gemm_pallas_blocks``, stride 1): per x-aligned 1x8
  block ``(by, bx)`` of output sites, the ``[kh, 8 + kw - 1, C]`` strip at
  ``(by, 8 * bx)`` gives ``out[b, s] = sum_{dy,dx} strip[dy, s + dx] @
  W[dy, dx]`` -> ``[K, 8, O]`` per plane.  A strip running past ``Wp``
  reads zeros there (the JAX package pads the planes instead).
* :func:`rulebook_gather_gemm` (K4, JAX ``rulebook_gather_gemm_pallas``):
  per site ``(ys, xs)`` the ``[kh, kw, C]`` box at ``(ys*s, xs*s)`` ->
  ``[K, O]`` per plane.

Both run the tiled, split-reduction gather-GEMM of ``csrc/gather_gemm.cu``,
which K5 (:mod:`async_ev_cnn_torch.ops.rows_gemm`) shares: K3 with its
block map, K4 with its per-site map at any stride.  Each launches it
through :func:`launch_gather_gemm` with the launch plan of
:func:`gather_gemm_plan`.

Both read the matmul tier (:mod:`async_ev_cnn_torch.ops.conv`): at
``'default'`` on the card the kernels and their plain versions round both
operands to TF32 and sum in float32; otherwise, and always on the CPU,
they multiply the float32 operands as they are.

The JAX package's channel padding to 128 lanes (``pad_lanes_128``) is a TPU
layout rule and has no counterpart.  A wrapper runs its plain version for
tensors on the CPU and the kernel for tensors on the card, or raises; it
never falls back.  ``LAUNCHES`` counts kernel launches per function.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from async_ev_cnn_torch.ops import cuda_build
from async_ev_cnn_torch.ops.cuda_build import check as _check
from async_ev_cnn_torch.ops.cuda_build import on_cpu as _on_cpu
from async_ev_cnn_torch.ops.cuda_build import ptr as _ptr
from async_ev_cnn_torch.ops.conv import tier_operands, tier_uses_tf32

BLOCK_W = 8

#: kernel launches per wrapper since the counts were last reset
LAUNCHES = {"rulebook_gather_gemm_blocks": 0, "rulebook_gather_gemm": 0}

# the gather-GEMM's instances (csrc/gather_gemm.cu): output sites a block
# (both planes: twice as many GEMM rows), output channels a block, reduction
# depth a slice, threads a block
GATHER_GEMM_TILES = {"narrow": (64, 16, 16, 128), "wide": (32, 64, 32, 256)}
#: blocks the plan fills with splits and does not pass: about two per SM of
#: the H100's 132 (a split more adds partial sums to write and add, and on
#: the eFCN's conv2 lost 14% on the H100: chip_smoke.py times S + 1)
GATHER_GEMM_TARGET_BLOCKS = 2 * 132
#: most reduction splits of one call
GATHER_GEMM_MAX_SPLITS = 32
#: the gather-GEMM's site-to-corner maps (``SiteMap`` in csrc/gather_gemm.cu):
#: K3's 1x8 blocks, K5's whole rows, K4's single sites at any stride
SITE_MAPS = {"blocks": 0, "rows": 1, "sites": 2}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _gather_boxes(plane, rows, cols):
    """``plane [Hp, Wp, C]`` at ``rows [K, A]`` x ``cols [K, B]`` ->
    ``[K, A, B, C]``, zeros where a row or column lies outside the plane."""
    hp, wp, _ = plane.shape
    ok = (((rows >= 0) & (rows < hp))[:, :, None]
          & ((cols >= 0) & (cols < wp))[:, None, :])
    r = rows.clamp(0, hp - 1).long()[:, :, None]
    c = cols.clamp(0, wp - 1).long()[:, None, :]
    zero = torch.zeros((), dtype=plane.dtype, device=plane.device)
    return torch.where(ok[..., None], plane[r, c], zero)


def _taps_gemm(boxes, kernel_hwio, bias, sites: int):
    """``bias + sum_{dy,dx} boxes[:, dy, dx + s] @ W[dy, dx]`` over the
    ``sites`` adjacent sites ``s`` of each box, per tap as the TPU kernels
    run it -> ``[K, sites, O]``; the operands rounded as the tier rounds
    them (:func:`~async_ev_cnn_torch.ops.conv.tier_operands`).  Operands
    rounded to TF32 pass a TF32 product unchanged, so each tap's product
    is exact at every tier and only the float32 sums round."""
    kh, kw, _, o = kernel_hwio.shape
    k = boxes.shape[0]
    boxes, kernel_hwio = tier_operands(boxes, kernel_hwio)
    acc = bias.float().expand(k, sites, o).clone()
    for dy in range(kh):
        for dx in range(kw):
            acc = acc + boxes[:, dy, dx:dx + sites, :] @ kernel_hwio[dy, dx]
    return acc


def rulebook_gather_gemm_blocks_plain(fm_hwc, ca_hwc, kernel_hwio, bias, by, bx):
    """Plain PyTorch version of :func:`rulebook_gather_gemm_blocks`."""
    kh, kw, _, o = kernel_hwio.shape
    dev = fm_hwc.device
    rows = by.long()[:, None] + torch.arange(kh, device=dev)[None, :]
    cols = (bx.long()[:, None] * BLOCK_W
            + torch.arange(BLOCK_W + kw - 1, device=dev)[None, :])
    zero_bias = torch.zeros_like(bias, dtype=torch.float32)
    return (
        _taps_gemm(_gather_boxes(fm_hwc.float(), rows, cols), kernel_hwio, bias,
                   BLOCK_W),
        _taps_gemm(_gather_boxes(ca_hwc.float(), rows, cols), kernel_hwio,
                   zero_bias, BLOCK_W),
    )


def rulebook_gather_gemm_plain(fm_hwc, ca_hwc, kernel_hwio, bias, ys, xs,
                               stride: int = 1):
    """Plain PyTorch version of :func:`rulebook_gather_gemm`."""
    kh, kw, _, o = kernel_hwio.shape
    dev = fm_hwc.device
    rows = ys.long()[:, None] * stride + torch.arange(kh, device=dev)[None, :]
    cols = xs.long()[:, None] * stride + torch.arange(kw, device=dev)[None, :]
    zero_bias = torch.zeros_like(bias, dtype=torch.float32)
    return (
        _taps_gemm(_gather_boxes(fm_hwc.float(), rows, cols), kernel_hwio, bias,
                   1)[:, 0],
        _taps_gemm(_gather_boxes(ca_hwc.float(), rows, cols), kernel_hwio,
                   zero_bias, 1)[:, 0],
    )


class GatherGemmPlan(NamedTuple):
    """How one gather-GEMM call is cut: ``tile`` names the instance
    (``'narrow'`` for O <= 16, else ``'wide'``; its shape is
    ``GATHER_GEMM_TILES[tile]``), the reduction in ``n_slices`` slices
    ``block_k`` deep, ``splits`` reduction splits over ``grid = (site
    tiles, channel tiles, splits)``, the ``[splits, 2, M, O]`` partial sums
    (None at one split) and the dynamic shared memory of a block's
    two-stage ring.  Split ``z`` takes slices ``[z * n_slices // splits,
    (z + 1) * n_slices // splits)``."""
    tile: str
    block_k: int
    n_slices: int
    splits: int
    grid: tuple[int, int, int]
    workspace: tuple[int, int, int, int] | None
    smem_bytes: int


def gather_gemm_plan(m: int, o: int, kh: int, kw: int, c: int,
                     splits: int | None = None) -> GatherGemmPlan:
    """The launch plan of a gather-GEMM over ``m`` output sites, ``o``
    output channels and a ``kh x kw x c`` reduction.  Where the site x
    channel tiles give fewer than :data:`GATHER_GEMM_TARGET_BLOCKS` blocks,
    the reduction's slices are split over the grid's third axis, as many
    splits as keep the grid within that count, at most one split a slice
    and :data:`GATHER_GEMM_MAX_SPLITS`.  ``splits``
    overrides that choice (clamped to one split a slice at most), for
    timing one split count against another."""
    tile = "narrow" if o <= 16 else "wide"
    sites, block_n, block_k, _ = GATHER_GEMM_TILES[tile]
    n_slices = max(1, -(-kh * kw * c // block_k))
    tiles = (-(-m // sites), -(-o // block_n))
    n_tiles = tiles[0] * tiles[1]
    if splits is not None:
        splits = max(1, min(splits, n_slices))
    elif n_tiles < GATHER_GEMM_TARGET_BLOCKS:
        splits = min(GATHER_GEMM_TARGET_BLOCKS // n_tiles, n_slices,
                     GATHER_GEMM_MAX_SPLITS)
    else:
        splits = 1
    smem = 4 * 2 * (2 * sites * (block_k + 4) + block_k * block_n)
    return GatherGemmPlan(tile, block_k, n_slices, splits, (*tiles, splits),
                          (splits, 2, m, o) if splits > 1 else None, smem)


def launch_gather_gemm(fm_hwc, ca_hwc, kernel_hwio, bias, ys, xs, out_fm, out_ca,
                       site_map: str, ow: int = 0, stride: int = 1,
                       splits: int | None = None) -> None:
    """Launch ``csrc/gather_gemm.cu`` once (and its split pass) on the
    card with one of :data:`SITE_MAPS`: ``'blocks'`` (K3: ``ys, xs`` =
    ``by, bx``), ``'rows'`` (K5: ``ys`` the rows, ``ow`` columns a row,
    ``xs`` None) or ``'sites'`` (K4: corners ``(ys * stride, xs *
    stride)``).  ``out_fm``/``out_ca`` are ``[M, O]`` contiguous;
    ``splits`` overrides the plan's (see :func:`gather_gemm_plan`).  The
    caller counts the launch."""
    kh, kw, c, o = kernel_hwio.shape
    hp, wp, _ = fm_hwc.shape
    m = out_fm.numel() // o
    if fm_hwc.numel() >= 2**31 or out_fm.numel() * 2 >= 2**31:
        raise ValueError("the gather-GEMM indexes its planes and outputs with int32")
    plan = gather_gemm_plan(m, o, kh, kw, c, splits)
    partial = (torch.empty(plan.workspace, dtype=torch.float32, device=out_fm.device)
               if plan.workspace else out_fm)
    a_vec = c % 4 == 0 and fm_hwc.data_ptr() % 16 == 0 and ca_hwc.data_ptr() % 16 == 0
    w_vec = o % 4 == 0 and kernel_hwio.data_ptr() % 16 == 0
    cuda_build.launch(
        "gather_gemm", "gather_gemm", out_fm.device, _ptr(fm_hwc), _ptr(ca_hwc),
        _ptr(kernel_hwio), _ptr(bias), _ptr(ys), _ptr(ys if xs is None else xs),
        _ptr(out_fm), _ptr(out_ca), _ptr(partial),
        *(ctypes.c_int(int(v)) for v in (
            m, hp, wp, c, o, kh, kw, ow, stride, SITE_MAPS[site_map], plan.tile == "wide",
            plan.grid[0], plan.grid[1], plan.splits, plan.smem_bytes, a_vec, w_vec,
            tier_uses_tf32())))


def _check_inputs(fm_hwc, ca_hwc, kernel_hwio, bias, ys, xs):
    dev = fm_hwc.device
    _check("fm_hwc", fm_hwc, torch.float32, dev, 3)
    _check("ca_hwc", ca_hwc, torch.float32, dev, 3)
    _check("kernel_hwio", kernel_hwio, torch.float32, dev, 4)
    _check("bias", bias, torch.float32, dev, 1)
    _check("ys", ys, torch.int32, dev, 1)
    _check("xs", xs, torch.int32, dev, 1)
    kh, kw, c, o = kernel_hwio.shape
    if (ca_hwc.shape != fm_hwc.shape or fm_hwc.shape[2] != c
            or bias.shape[0] != o or xs.shape != ys.shape):
        raise ValueError(
            f"shape mismatch: fm {tuple(fm_hwc.shape)}, ca {tuple(ca_hwc.shape)}, "
            f"kernel {tuple(kernel_hwio.shape)}, bias {tuple(bias.shape)}, "
            f"coordinates {tuple(ys.shape)} and {tuple(xs.shape)}")
    return dev, kh, kw, c, o


def rulebook_gather_gemm_blocks(fm_hwc, ca_hwc, kernel_hwio, bias, by, bx,
                                stride: int = 1):
    """Block-sparse rulebook gather + GEMM (K3).

    Args:
      fm_hwc, ca_hwc: f32 ``[Hp, Wp, C]`` padded featuremap / conv-actfn.
      kernel_hwio: f32 ``[kh, kw, C, O]``.
      bias: f32 ``[O]``, added to the featuremap plane only.
      by, bx: int32 ``[K]`` block rows (sites) and columns (``BLOCK_W``
        units).

    Returns ``(fm_vals, cact_vals)``, f32 ``[K, BLOCK_W, O]`` each.
    """
    if stride != 1:
        raise NotImplementedError("block rulebook requires stride 1")
    if _on_cpu(fm_hwc, ca_hwc, kernel_hwio, bias, by, bx):
        return rulebook_gather_gemm_blocks_plain(fm_hwc, ca_hwc, kernel_hwio,
                                                 bias, by, bx)
    dev, kh, kw, c, o = _check_inputs(fm_hwc, ca_hwc, kernel_hwio, bias, by, bx)
    k = by.shape[0]
    out_fm = torch.empty((k, BLOCK_W, o), dtype=torch.float32, device=dev)
    out_ca = torch.empty_like(out_fm)
    if out_fm.numel() == 0:
        return out_fm, out_ca  # nothing to compute: no launch, nothing counted
    launch_gather_gemm(fm_hwc, ca_hwc, kernel_hwio, bias, by, bx, out_fm, out_ca, "blocks")
    LAUNCHES["rulebook_gather_gemm_blocks"] += 1
    return out_fm, out_ca


def rulebook_gather_gemm(fm_hwc, ca_hwc, kernel_hwio, bias, ys, xs,
                         stride: int = 1):
    """Per-site rulebook gather + GEMM (K4).

    Args as :func:`rulebook_gather_gemm_blocks`, with ``ys, xs`` int32
    ``[K]`` output sites whose receptive fields start at
    ``(ys * stride, xs * stride)`` in the padded planes.

    Returns ``(fm_vals, cact_vals)``, f32 ``[K, O]`` each.
    """
    if _on_cpu(fm_hwc, ca_hwc, kernel_hwio, bias, ys, xs):
        return rulebook_gather_gemm_plain(fm_hwc, ca_hwc, kernel_hwio, bias,
                                          ys, xs, stride)
    dev, kh, kw, c, o = _check_inputs(fm_hwc, ca_hwc, kernel_hwio, bias, ys, xs)
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    k = ys.shape[0]
    out_fm = torch.empty((k, o), dtype=torch.float32, device=dev)
    out_ca = torch.empty_like(out_fm)
    if out_fm.numel() == 0:
        return out_fm, out_ca  # nothing to compute: no launch, nothing counted
    launch_gather_gemm(fm_hwc, ca_hwc, kernel_hwio, bias, ys, xs, out_fm, out_ca, "sites",
                       stride=stride)
    LAUNCHES["rulebook_gather_gemm"] += 1
    return out_fm, out_ca
