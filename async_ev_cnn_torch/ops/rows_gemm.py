"""Row-granular gather-GEMM (K5): the conv of whole active output rows.

Counterpart of ``async_ev_cnn_tpu/ops/pallas_rows.py``.  It keeps the JAX
signature: padded HWC ``[Hp, Wp, C]`` featuremap and conv-actfn planes, an
HWIO ``[kh, kw, C, O]`` kernel, a ``[O]`` bias (added to the featuremap
plane only) and int32 ``[R]`` active output rows (stride 1) ->
``(fm_rows, ca_rows)``, f32 ``[R, ow, O]`` each, ``ow = Wp - kw + 1``.
The hand-written kernel is K3's tiled gather-GEMM in
``csrc/gather_gemm.cu`` with the row map: site ``(r, x)``, ``x < ow``, has
its corner at ``(row_idx[r], x)``, so it computes exactly the ``R * ow``
output sites.  The plain version is the tap loop of the TPU kernel.  Both
read the matmul tier as K3 does
(:mod:`async_ev_cnn_torch.ops.rulebook_gemm`).

As in the JAX package, no conv mode runs it: 'sparse_rows' keeps its
gather plus one conv (:func:`async_ev_cnn_torch.ops.rulebook.
rows_conv_pair`).  :func:`kernel_rows_conv_pair` is the same update through
K5, which is how the kernel is held against that path.  The TPU's channel
padding to 128 lanes has no counterpart.  A wrapper runs its plain version
for tensors on the CPU and the kernel for tensors on the card, or raises.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from async_ev_cnn_torch.ops.cuda_build import check as _check
from async_ev_cnn_torch.ops.cuda_build import on_cpu as _on_cpu
from async_ev_cnn_torch.ops.rulebook import active_rows
from async_ev_cnn_torch.ops.rulebook_gemm import _gather_boxes, _taps_gemm, launch_gather_gemm

#: kernel launches since the counts were last reset
LAUNCHES = {"rows_gather_conv": 0}


def reset_launches() -> None:
    LAUNCHES["rows_gather_conv"] = 0


def rows_gather_conv_plain(fm_hwc, ca_hwc, kernel_hwio, bias, row_idx):
    """Plain PyTorch version of :func:`rows_gather_conv`: the ``[kh, Wp,
    C]`` windows of both planes, then ``bias + sum_taps [ow, C] @ [C, O]``."""
    kh, kw, _, _ = kernel_hwio.shape
    wp = fm_hwc.shape[1]
    ow = wp - kw + 1
    dev = fm_hwc.device
    r = row_idx.shape[0]
    rows = row_idx.long()[:, None] + torch.arange(kh, device=dev)[None, :]
    cols = torch.arange(wp, device=dev).expand(r, wp)
    zero_bias = torch.zeros_like(bias, dtype=torch.float32)
    return (_taps_gemm(_gather_boxes(fm_hwc.float(), rows, cols), kernel_hwio, bias, ow),
            _taps_gemm(_gather_boxes(ca_hwc.float(), rows, cols), kernel_hwio,
                       zero_bias, ow))


def rows_gather_conv(fm_hwc, ca_hwc, kernel_hwio, bias, row_idx):
    """Row-granular gather + GEMM (K5).

    Args:
      fm_hwc, ca_hwc: f32 ``[Hp, Wp, C]`` padded featuremap / conv-actfn.
      kernel_hwio: f32 ``[kh, kw, C, O]``.
      bias: f32 ``[O]``, added to the featuremap plane only.
      row_idx: int32 ``[R]`` output rows; row ``r`` reads padded rows
        ``row_idx[r] .. row_idx[r] + kh - 1`` (zeros outside the plane).

    Returns ``(fm_rows, ca_rows)``, f32 ``[R, Wp - kw + 1, O]`` each.
    """
    if _on_cpu(fm_hwc, ca_hwc, kernel_hwio, bias, row_idx):
        return rows_gather_conv_plain(fm_hwc, ca_hwc, kernel_hwio, bias, row_idx)
    dev = fm_hwc.device
    _check("fm_hwc", fm_hwc, torch.float32, dev, 3)
    _check("ca_hwc", ca_hwc, torch.float32, dev, 3)
    _check("kernel_hwio", kernel_hwio, torch.float32, dev, 4)
    _check("bias", bias, torch.float32, dev, 1)
    _check("row_idx", row_idx, torch.int32, dev, 1)
    _, kw, c, o = kernel_hwio.shape
    wp = fm_hwc.shape[1]
    if ca_hwc.shape != fm_hwc.shape or fm_hwc.shape[2] != c or bias.shape[0] != o:
        raise ValueError(
            f"shape mismatch: fm {tuple(fm_hwc.shape)}, ca {tuple(ca_hwc.shape)}, "
            f"kernel {tuple(kernel_hwio.shape)}, bias {tuple(bias.shape)}")
    if wp < kw:
        raise ValueError(f"plane width {wp} is narrower than the kernel's {kw}")
    ow = wp - kw + 1
    out_fm = torch.empty((row_idx.shape[0], ow, o), dtype=torch.float32, device=dev)
    out_ca = torch.empty_like(out_fm)
    if out_fm.numel() == 0:  # nothing to compute: no launch, nothing counted
        return out_fm, out_ca
    launch_gather_gemm(fm_hwc, ca_hwc, kernel_hwio, bias, row_idx, None, out_fm, out_ca, "rows",
                       ow=ow)
    LAUNCHES["rows_gather_conv"] += 1
    return out_fm, out_ca


def kernel_rows_conv_pair(featuremap, conv_actfn, active, kernel, bias,
                          row_capacity: int, pads):
    """:func:`async_ev_cnn_torch.ops.rulebook.rows_conv_pair` at stride 1
    through K5: the same active rows, the planes padded and laid out HWC,
    one K5 call.  Returns ``(row_idx, row_valid, fm_rows [R, O, ow],
    ca_rows [R, O, ow], overflow)``, as ``rows_conv_pair`` does."""
    row_idx, row_valid, overflow = active_rows(active, row_capacity)
    (pt, pb), (pl, pr) = pads

    def hwc(plane):
        return F.pad(plane.float(), (pl, pr, pt, pb)).permute(1, 2, 0).contiguous()

    fm_rows, ca_rows = rows_gather_conv(
        hwc(featuremap), hwc(conv_actfn),
        kernel.permute(2, 3, 1, 0).contiguous().float(),  # OIHW -> HWIO
        bias.float().contiguous(), row_idx.to(torch.int32))
    return (row_idx, row_valid, fm_rows.permute(0, 2, 1), ca_rows.permute(0, 2, 1),
            overflow)
