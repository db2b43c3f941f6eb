"""Rulebook gather-GEMM kernels of the 'sparse_pallas' conv mode.

Counterpart of ``async_ev_cnn_tpu/ops/pallas_rulebook_blocks.py`` and
``async_ev_cnn_tpu/ops/pallas_rulebook.py``.  Two functions, each with a
hand-written CUDA kernel (``csrc/rulebook.cu``) and a plain PyTorch version
of the same arithmetic; both take the JAX signatures' layouts: padded HWC
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

The JAX package's channel padding to 128 lanes (``pad_lanes_128``) is a TPU
layout rule and has no counterpart.  A wrapper runs its plain version for
tensors on the CPU and the kernel for tensors on the card, or raises; it
never falls back.  ``LAUNCHES`` counts kernel launches per function.
"""

from __future__ import annotations

import ctypes

import torch

from async_ev_cnn_torch.ops import cuda_build
from async_ev_cnn_torch.ops.cuda_build import check as _check
from async_ev_cnn_torch.ops.cuda_build import on_cpu as _on_cpu
from async_ev_cnn_torch.ops.cuda_build import ptr as _ptr

BLOCK_W = 8

#: kernel launches per wrapper since the counts were last reset
LAUNCHES = {"rulebook_gather_gemm_blocks": 0, "rulebook_gather_gemm": 0}

# the kernels' block shape (csrc/rulebook.cu): 16 output sites by 32
# output channels a block, the inputs and weights staged in shared memory a
# chunk of channels at a time under this budget
_SITES_PER_BLOCK = 16
_O_TILE = 32
_STAGE_BYTES = 40 * 1024


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
    run it -> ``[K, sites, O]``."""
    kh, kw, _, o = kernel_hwio.shape
    k = boxes.shape[0]
    acc = bias.float().expand(k, sites, o).clone()
    for dy in range(kh):
        for dx in range(kw):
            acc = acc + boxes[:, dy, dx:dx + sites, :] @ kernel_hwio[dy, dx].float()
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


def _channel_chunk(boxes: int, kh: int, kw: int, box_w: int, c: int) -> int:
    """Channels staged per pass so both planes' boxes and the weight tile
    fit the budget."""
    per_channel = 4 * (2 * boxes * kh * box_w + kh * kw * _O_TILE)
    if per_channel > _STAGE_BYTES:
        raise ValueError(
            f"a {kh}x{box_w} receptive field does not fit the kernels' shared "
            "memory stage")
    return min(c, _STAGE_BYTES // per_channel)


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


def _launch(fn_name: str, device, *args) -> None:
    cuda_build.launch("rulebook", fn_name, device, *args)
    LAUNCHES[fn_name] += 1


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
    hp, wp, _ = fm_hwc.shape
    chunk = _channel_chunk(_SITES_PER_BLOCK // BLOCK_W, kh, kw, BLOCK_W + kw - 1, c)
    _launch("rulebook_gather_gemm_blocks", dev, _ptr(fm_hwc), _ptr(ca_hwc),
            _ptr(kernel_hwio), _ptr(bias), _ptr(by), _ptr(bx), _ptr(out_fm), _ptr(out_ca),
            *(ctypes.c_int(v) for v in (k, hp, wp, c, o, kh, kw, chunk)))
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
    hp, wp, _ = fm_hwc.shape
    chunk = _channel_chunk(_SITES_PER_BLOCK, kh, kw, kw, c)
    _launch("rulebook_gather_gemm", dev, _ptr(fm_hwc), _ptr(ca_hwc),
            _ptr(kernel_hwio), _ptr(bias), _ptr(ys), _ptr(xs), _ptr(out_fm), _ptr(out_ca),
            *(ctypes.c_int(v) for v in (k, hp, wp, c, o, kh, kw, stride, chunk)))
    return out_fm, out_ca
