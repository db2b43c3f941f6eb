"""Fused eFCN stem (K6): ``maxpool2x2(leaky(conv3x3_SAME(x) + b))`` for a
one-channel input in one kernel.

Counterpart of ``examples/pallas_stem_negative.py``, which the JAX package
keeps as a measured alternative to its library stem (a negative result on
its TPU).  The port keeps it the same way: no network path runs it; it is
timed beside the library stem (the direct conv1 -> pool1 and
:func:`async_ev_cnn_torch.ops.stem.fused_conv_pool`).  The hand-written
kernel is ``csrc/fused_stem.cu``.  The plain version runs the TPU kernel's
float32 operations in its order: ``acc = b``, then ``acc + x * w`` tap by
tap, product and sum rounded apart, the activation, the 2x2 max.  The
kernel takes the same taps in the same order but rounds each tap once (a
fused multiply-add) and, for ``0 <= alpha <= 1``, activates after the max
(the activation is monotone there), so the two agree within a few float32
ulps, not bit for bit; ``chip_smoke.py`` states the tolerance.  The
activation is ``where(x > 0, x, alpha * x)`` here, as in the TPU kernel
(equal to the network's ``max(x, alpha * x)`` for 0 <= alpha <= 1).  A wrapper runs its
plain version for tensors on the CPU and the kernel for tensors on the
card, or raises.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from async_ev_cnn_torch.ops import cuda_build
from async_ev_cnn_torch.ops.cuda_build import check as _check
from async_ev_cnn_torch.ops.cuda_build import on_cpu as _on_cpu
from async_ev_cnn_torch.ops.cuda_build import ptr as _ptr
from async_ev_cnn_torch.ops.numerics import float32_scalar

#: kernel launches since the counts were last reset
LAUNCHES = {"fused_stem": 0}

#: output channels the kernel's __constant__ block holds (csrc/fused_stem.cu)
STEM_MAX_O = 64


def reset_launches() -> None:
    LAUNCHES["fused_stem"] = 0


def w_taps_from_oihw(kernel: torch.Tensor) -> torch.Tensor:
    """An OIHW ``[O, 1, 3, 3]`` kernel as the ``[9, O]`` taps, dy-major."""
    o, cin, kh, kw = kernel.shape
    if (cin, kh, kw) != (1, 3, 3):
        raise ValueError(f"the fused stem takes a [O, 1, 3, 3] kernel, got "
                         f"{tuple(kernel.shape)}")
    return kernel[:, 0].permute(1, 2, 0).reshape(9, o).contiguous()


def fused_stem_plain(x, w_taps, bias, alpha: float = 0.1):
    """Plain PyTorch version of :func:`fused_stem`."""
    t, h, w = x.shape
    o = w_taps.shape[1]
    xp = F.pad(x.float(), (1, 1, 1, 1))[:, None]            # [T, 1, H+2, W+2]
    acc = bias.float().reshape(1, o, 1, 1).expand(t, o, h, w)
    for dy in range(3):
        for dx in range(3):
            tap = w_taps[dy * 3 + dx].float().reshape(1, o, 1, 1)
            acc = acc + xp[:, :, dy:dy + h, dx:dx + w] * tap
    acc = torch.where(acc > 0, acc, acc * float32_scalar(alpha, "cpu"))
    return acc.reshape(t, o, h // 2, 2, w // 2, 2).amax(dim=(3, 5))


def fused_stem(x, w_taps, bias, alpha: float = 0.1):
    """``x`` f32 ``[T, H, W]`` (H, W even), ``w_taps`` f32 ``[9, O]``,
    ``bias`` f32 ``[O]`` -> f32 ``[T, O, H/2, W/2]``."""
    if x.dim() != 3 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"the fused stem takes x [T, H, W] with even H and W "
                         f"(one input channel), got {tuple(x.shape)}")
    if w_taps.dim() != 2 or not 1 <= w_taps.shape[1] <= STEM_MAX_O:
        raise ValueError(f"the fused stem takes w_taps [9, O] with 1 <= O <= {STEM_MAX_O} "
                         f"(its kernel's constant block), got {tuple(w_taps.shape)}")
    if _on_cpu(x, w_taps, bias):
        return fused_stem_plain(x, w_taps, bias, alpha)
    dev = x.device
    _check("x", x, torch.float32, dev, 3)
    _check("w_taps", w_taps, torch.float32, dev, 2)
    _check("bias", bias, torch.float32, dev, 1)
    t, h, w = x.shape
    o = w_taps.shape[1]
    if w_taps.shape[0] != 9 or bias.shape[0] != o:
        raise ValueError(f"w_taps must be [9, O] and bias [O], got "
                         f"{tuple(w_taps.shape)} and {tuple(bias.shape)}")
    out = torch.empty((t, o, h // 2, w // 2), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out  # nothing to compute: no launch, nothing counted
    cuda_build.launch("fused_stem", "fused_stem", dev, _ptr(x), _ptr(w_taps),
                      _ptr(bias), _ptr(out),
                      *(ctypes.c_int(v) for v in (t, h, w, o)), ctypes.c_float(alpha))
    LAUNCHES["fused_stem"] += 1
    return out
