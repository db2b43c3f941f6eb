"""The epilogue of a conv: its bias, the leaky activation and, if asked,
the 2x2 stride-2 max-pool after them, in one pass over the conv's raw
output (``conv2d_dense(..., bias=None)``).  Its SiLU form, ``act='silu'``
(``v * sigmoid(v)``, YOLOX's conv + folded batch norm + SiLU), finishes an
unpooled conv the same way: SiLU is not monotone, so it never pools.

No Pallas kernel stands behind it: the JAX package leaves this fusion to
XLA, which folds bias, activation and ``reduce_window`` into the conv's
output fusion.  The hand-written kernel is ``csrc/conv_epilogue.cu``; its
plain version, :func:`conv_epilogue_plain`, is the eager sequence of the
unfused layers: the bias add of :func:`~async_ev_cnn_torch.ops.conv.
conv2d_dense`, :func:`~async_ev_cnn_torch.ops.conv.leaky`, the cast to the
layer's activation dtype and :func:`~async_ev_cnn_torch.ops.pool.
maxpool_dense`'s 2x2 VALID pool.  The two are equal value for value (a
zero's sign aside): for ``0 < alpha <= 1`` the bias add, the activation and
the bf16 rounding are each nondecreasing, so pooling before them gives the
max of what pooling after them gives (the source says more).  Pooling is
taken for such ``alpha`` only.

A call runs inside one ``conv.leaky`` span: the passes over a conv's
output after cuDNN's conv.  The wrapper runs the plain version for tensors
on the CPU and the kernel for tensors on the card, or raises.  Under
autograd the kernel's backward recomputes the plain version and backpropagates
through it, so the gradients are the unfused layers'.  ``LAUNCHES`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from async_ev_cnn_torch.ops import cuda_build
from async_ev_cnn_torch.ops.conv import activate
from async_ev_cnn_torch.ops.cuda_build import check as _check
from async_ev_cnn_torch.ops.cuda_build import on_cpu as _on_cpu
from async_ev_cnn_torch.ops.cuda_build import ptr as _ptr
from async_ev_cnn_torch.utils.profiling import span

#: kernel launches since the counts were last reset (``conv_epilogue_silu``:
#: those of the SiLU form, counted in ``conv_epilogue`` too)
LAUNCHES = {"conv_epilogue": 0, "conv_epilogue_silu": 0}

_STORE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def reset_launches() -> None:
    LAUNCHES["conv_epilogue"] = LAUNCHES["conv_epilogue_silu"] = 0


def pools_exactly(alpha: float) -> bool:
    """Whether the pool may run before the activation with an exact result:
    ``0 < alpha <= 1`` once rounded to float32 (at 0, ``-inf * 0`` is NaN)."""
    return 0.0 < float(np.float32(alpha)) <= 1.0


#: the activations, by name: the kernel's flag
ACTS = {"leaky": 0, "silu": 1}


def _check_args(x, bias, act_dtype, pooled=False, act="leaky"):
    if x.dim() not in (3, 4) or bias.dim() != 1 or bias.shape[0] != x.shape[-3]:
        raise ValueError(f"the conv epilogue takes x [(N,) C, H, W] and bias [C], got "
                         f"{tuple(x.shape)} and {tuple(bias.shape)}")
    if act_dtype not in _STORE:
        raise ValueError(f"act_dtype must be one of {sorted(_STORE)}, got {act_dtype!r}")
    if act not in ACTS or pooled and act != "leaky":
        raise ValueError(f"the conv epilogue takes act 'leaky', or 'silu' unpooled, got "
                         f"{act!r} (pooled={pooled})")


def conv_epilogue_plain(x, bias, alpha: float, act_dtype: str = "float32",
                        pooled: bool = False, act: str = "leaky"):
    """Plain PyTorch version of :func:`conv_epilogue`: the unfused layers'
    eager sequence.  The bias is added into ``x`` in place, as
    ``conv2d_dense`` adds it into the conv's output, so a call holds two
    maps of ``x``'s size, as the unfused layers did."""
    x.add_(bias.float().reshape(-1, 1, 1))
    y = (F.silu(x) if act == "silu" else activate(x, alpha)).to(_STORE[act_dtype])
    if pooled:
        y = F.max_pool2d(y[None] if y.dim() == 3 else y, (2, 2), 2)
        y = y[0] if x.dim() == 3 else y
    return y


def _launch(x, bias, alpha: float, act_dtype: str, pooled: bool, act: str = "leaky"):
    """One launch of the kernel on ``x``'s card; it refuses to pool for
    ``alpha`` outside ``0 < alpha <= 1`` (:func:`pools_exactly`) or with
    SiLU."""
    dev = x.device
    _check("x", x, torch.float32, dev, x.dim())
    _check("bias", bias, torch.float32, dev, 1)
    c, h, w = x.shape[-3:]
    oh, ow = (h // 2, w // 2) if pooled else (h, w)
    out = torch.empty((*x.shape[:-2], oh, ow), dtype=_STORE[act_dtype], device=dev)
    if out.numel() == 0:
        return out  # nothing to compute: no launch, nothing counted
    cuda_build.launch("conv_epilogue", "conv_epilogue", dev, _ptr(x), _ptr(bias), _ptr(out),
                      ctypes.c_longlong(x.numel() // (h * w)), ctypes.c_int(c),
                      ctypes.c_int(h), ctypes.c_int(w), ctypes.c_float(alpha),
                      ctypes.c_int(pooled), ctypes.c_int(act_dtype == "bfloat16"),
                      ctypes.c_int(ACTS[act]))
    LAUNCHES["conv_epilogue"] += 1
    LAUNCHES["conv_epilogue_silu"] += act == "silu"
    return out


class _Epilogue(torch.autograd.Function):
    """The kernel, with the plain version's gradients: the backward
    recomputes :func:`conv_epilogue_plain` from the saved raw output and
    backpropagates through it."""

    @staticmethod
    def forward(ctx, x, bias, alpha, act_dtype, pooled, act="leaky"):
        ctx.save_for_backward(x, bias)
        ctx.args = (alpha, act_dtype, pooled, act)
        return _launch(x, bias, alpha, act_dtype, pooled, act)

    @staticmethod
    def backward(ctx, grad):
        x, bias = ctx.saved_tensors
        with torch.enable_grad():
            xr = x.detach().requires_grad_(ctx.needs_input_grad[0])
            br = bias.detach().requires_grad_(ctx.needs_input_grad[1])
            # the plain version adds the bias in place: give it a copy
            y = conv_epilogue_plain(xr.clone(), br, *ctx.args)
            wrt = [t for t in (xr, br) if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wrt, grad))
        return (next(grads) if xr.requires_grad else None,
                next(grads) if br.requires_grad else None,
                *(None,) * (len(ctx.needs_input_grad) - 2))


def conv_epilogue(x, bias, alpha: float, act_dtype: str = "float32",
                  pooled: bool = False, act: str = "leaky"):
    """``x`` f32 ``[(N,) C, H, W]`` (a conv's output without its bias),
    ``bias`` f32 ``[C]`` -> ``act(x + bias)``, or with ``pooled``
    ``act(maxpool2x2(x) + bias)`` at ``[(N,) C, H//2, W//2]``, stored as
    ``act_dtype`` ('float32' or 'bfloat16'); ``act(v) = max(v, v * alpha)``,
    or with ``act='silu'`` (unpooled) ``v / (1 + exp(-v))``, as ``F.silu``
    computes it.  On the CPU ``x`` is consumed (:func:`conv_epilogue_plain`)."""
    _check_args(x, bias, act_dtype, pooled, act)
    with span("conv.leaky"):
        if _on_cpu(x, bias):
            return conv_epilogue_plain(x, bias, alpha, act_dtype, pooled, act)
        return _Epilogue.apply(x, bias, alpha, act_dtype, pooled, act)
