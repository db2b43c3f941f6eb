"""Fused stem (K6): ``maxpool2x2(leaky(conv3x3_SAME(x) + b))`` for a
one-channel input in one kernel.

Counterpart of ``examples/pallas_stem_negative.py``, which the JAX package
keeps as a measured alternative to its library stem (a negative result on
its TPU).  In the port it runs the one-channel stem of the parallel
path's conv stack on the card (``layers/conv_stack.py`` decides where).
The hand-written kernel is ``csrc/fused_stem.cu``.  The plain version runs
the TPU kernel's float32 operations in its order: ``acc = b``, then ``acc + x * w`` tap by
tap, product and sum rounded apart, the activation, the 2x2 max.  The
kernel takes the same taps in the same order but rounds each tap once (a
fused multiply-add, from zero) and, for ``0 <= alpha <= 1``, adds the bias
and activates after the max (both are monotone there): the roundings of
cuDNN's conv and the pooled epilogue, the library stem it replaces.  So
kernel and plain version agree within ``K6_TOL * (1 + max|plain|)``,
:data:`K6_TOL` = 1e-6, not bit for bit: a conv value moves by at most half
an ulp of each of the 9 products and 10 partial sums, 19 half-ulps of the
chain's largest term (about 1.1e-6 of it, far less in practice, as the
roundings are independent), and the 2x2 max and the activation add none
(monotone for 0 <= alpha <= 1; the same order otherwise).  The
activation is ``where(x > 0, x, alpha * x)`` here, as in the TPU kernel
(equal to the network's ``max(x, alpha * x)`` for 0 <= alpha <= 1).  A
call runs inside one ``conv.stem`` span.  The kernel takes the taps and
the bias by value, as launch parameters, so it reads them in host memory
(:func:`host_weights` keeps them there once per weight tensor).  A wrapper
runs its plain version for an input on the CPU and the kernel for an input
on the card, or raises.  ``LAUNCHES`` counts kernel launches.
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
from async_ev_cnn_torch.utils.profiling import span

#: kernel launches since the counts were last reset
LAUNCHES = {"fused_stem": 0}

#: output channels the kernel's parameter struct holds (csrc/fused_stem.cu)
STEM_MAX_O = 64

#: K6 against its plain version or the library stem: ``|kernel - ref| <=
#: K6_TOL * (1 + max|ref|)`` (the module docstring derives it)
K6_TOL = 1e-6

_HOST = torch.device("cpu")


def reset_launches() -> None:
    LAUNCHES["fused_stem"] = 0


def _version(t: torch.Tensor):
    """``t``'s version counter, or None for an inference tensor (it has none)."""
    return None if t.is_inference() else t._version


def host_weights(cache: dict, key, kernel: torch.Tensor, bias: torch.Tensor):
    """The kernel's weights of an OIHW ``[O, 1, 3, 3]`` ``kernel`` and its
    ``bias``: the ``[9, O]`` taps and the bias, float32 in host memory.
    They are made once per pair of weight tensors, by identity and
    version, and kept in ``cache`` under ``key``: a call that finds them
    there copies nothing and does not wait for the card.  An inference
    tensor keeps no version, so its weights are made at every call."""
    stamp = (_version(kernel), _version(bias))
    hit = cache.get(key)
    if (hit is None or hit[0] is not kernel or hit[1] is not bias or hit[2] != stamp
            or None in stamp):
        hit = (kernel, bias, stamp, w_taps_from_oihw(kernel.detach().float()).cpu(),
               bias.detach().float().contiguous().cpu())
        cache[key] = hit
    return hit[3], hit[4]


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
    ``bias`` f32 ``[O]`` -> f32 ``[T, O, H/2, W/2]``.  For ``x`` on the
    card the weights go into the launch's parameters from host memory:
    weights on the card are fetched first, which waits for it."""
    if x.dim() != 3 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"the fused stem takes x [T, H, W] with even H and W "
                         f"(one input channel), got {tuple(x.shape)}")
    if w_taps.dim() != 2 or not 1 <= w_taps.shape[1] <= STEM_MAX_O:
        raise ValueError(f"the fused stem takes w_taps [9, O] with 1 <= O <= {STEM_MAX_O} "
                         f"(its kernel's parameter struct), got {tuple(w_taps.shape)}")
    with span("conv.stem"):
        if not x.is_cuda and _on_cpu(x, w_taps, bias):
            return fused_stem_plain(x, w_taps, bias, alpha)
        dev = x.device
        _check("x", x, torch.float32, dev, 3)
        w_taps, bias = w_taps.detach().cpu(), bias.detach().cpu()
        _check("w_taps", w_taps, torch.float32, _HOST, 2)
        _check("bias", bias, torch.float32, _HOST, 1)
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
