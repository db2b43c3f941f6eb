"""Dense 2-D convolution with TF-compatible padding.

Counterpart of ``async_ev_cnn_tpu/ops/conv.py``.  The TF SAME pad formulas
are copied verbatim; the conv is ``F.conv2d`` on the TF-padded input.

Matmul tiers.  The JAX package names three operand precisions for every
conv and GEMM; on the TPU ``highest`` is full float32, ``high`` bf16x3 and
``default`` one bf16 pass.  On Hopper they map to:

* ``highest``: IEEE float32 in cuDNN (convs) and cuBLAS (the fc tail), TF32
  off in both.  PyTorch's default lets cuDNN run float32 convs in TF32,
  which would quietly break the <= 1e-4 async-vs-dense contract.
* ``high``: IEEE float32 too.  bf16x3 keeps about 16 bits of mantissa;
  TF32 keeps 10, so TF32 would be a less accurate tier than the one it
  stands for, and neither library offers a 3-pass TF32 conv.
* ``default``: TF32 in cuDNN and cuBLAS (``allow_tf32``).  The hand-written
  gather-GEMM kernels round both operands to TF32 (``cvt.rna.tf32.f32``)
  and sum in float32, as the JAX kernels read ``matmul_precision()``.

:func:`conv2d_dense` applies the tier again before every conv on the card
(the tier is process-wide here as in the JAX package).  On the CPU the tier
changes nothing, as the JAX CPU backend ignores ``Precision``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from async_ev_cnn_torch.ops.numerics import float32_scalar
from async_ev_cnn_torch.utils.profiling import span

_TIERS = ("highest", "high", "default")
_MATMUL_PRECISION = "highest"


def set_matmul_precision(name: str) -> None:
    """Set the process-wide conv/GEMM precision tier: ``'highest'``,
    ``'high'`` or ``'default'`` (see the module docstring for the Hopper
    mapping)."""
    global _MATMUL_PRECISION
    if name not in _TIERS:
        raise ValueError(
            f"matmul precision must be one of {sorted(_TIERS)}, got {name!r}")
    _MATMUL_PRECISION = name
    _apply_tier()


def matmul_precision() -> str:
    return _MATMUL_PRECISION


def tier_uses_tf32() -> bool:
    """True when the current tier runs float32 products as TF32 on the card."""
    return _MATMUL_PRECISION == "default"


def _apply_tier() -> None:
    tf32 = tier_uses_tf32()
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 ``x`` to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` does: add half of the dropped
    13-bit ulp to the magnitude bits, then clear them (a carry into the
    exponent is the correct rounding up).  Finite inputs only."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tier_operands(*tensors):
    """The kernels' operands as the current tier rounds them: TF32 on the
    card at ``'default'``, unchanged otherwise (on the CPU the tier changes
    nothing).  The plain versions of the gather-GEMM kernels call this so
    that on the card they compute what the kernels compute."""
    if tier_uses_tf32() and all(t.is_cuda for t in tensors):
        return tuple(round_tf32(t) for t in tensors)
    return tuple(t.float() for t in tensors)


def tf_same_pads(in_h: int, in_w: int, k_h: int, k_w: int, stride: int):
    """TF SAME padding amounts ((top, bottom), (left, right))."""
    if in_h % stride == 0:
        pad_along_h = max(k_h - stride, 0)
    else:
        pad_along_h = max(k_h - (in_h % stride), 0)
    if in_w % stride == 0:
        pad_along_w = max(k_w - stride, 0)
    else:
        pad_along_w = max(k_w - (in_w % stride), 0)
    pad_top = pad_along_h // 2
    pad_left = pad_along_w // 2
    return (pad_top, pad_along_h - pad_top), (pad_left, pad_along_w - pad_left)


def conv_pads(in_h: int, in_w: int, k_h: int, k_w: int, stride: int, padding: str):
    """Explicit pads for 'SAME', 'VALID' or 'HALF' padding.  'HALF' pads
    ``k // 2`` on each side whatever the stride (PyTorch's ``padding=k //
    2``, which RVT's and YOLOX's strided convs use); at stride 1 with an odd
    kernel it is 'SAME'."""
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding == "SAME":
        return tf_same_pads(in_h, in_w, k_h, k_w, stride)
    if padding == "HALF":
        return (k_h // 2, k_h // 2), (k_w // 2, k_w // 2)
    raise ValueError(f"padding must be 'SAME', 'VALID' or 'HALF', got {padding!r}")


def conv_out_shape(in_h: int, in_w: int, k_h: int, k_w: int, stride: int, padding: str):
    """Output spatial shape."""
    if padding == "VALID":
        return (in_h - k_h) // stride + 1, (in_w - k_w) // stride + 1
    if padding == "SAME":
        return -(-in_h // stride), -(-in_w // stride)
    if padding == "HALF":
        return ((in_h + 2 * (k_h // 2) - k_h) // stride + 1,
                (in_w + 2 * (k_w // 2) - k_w) // stride + 1)
    raise ValueError(f"padding must be 'SAME', 'VALID' or 'HALF', got {padding!r}")


def conv2d_dense(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None,
    stride: int | tuple[int, int] = 1,
    padding: str = "VALID",
) -> torch.Tensor:
    """Dense conv of ``x`` ``[C, H, W]`` or ``[N, C, H, W]`` with ``kernel``
    ``[O, I, kh, kw]`` (OIHW) and the TF pads of ``padding``.  A
    ``(row, column)`` stride pair is taken with VALID padding only."""
    if not isinstance(stride, int) and padding != "VALID":
        raise ValueError("a (row, column) stride pair needs VALID padding")
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    _, _, in_h, in_w = x.shape
    _, _, k_h, k_w = kernel.shape
    (pt, pb), (pl, pr) = conv_pads(in_h, in_w, k_h, k_w, stride, padding)
    if x.is_cuda:
        _apply_tier()
    x = x.float()
    with span("conv.gemm"):
        if pt == pb and pl == pr:
            # symmetric pads (every stride-1 odd kernel): let the conv pad
            # instead of materialising a padded copy of the input
            out = F.conv2d(x, kernel.float(), None, stride=stride, padding=(pt, pl))
        else:
            out = F.conv2d(F.pad(x, (pl, pr, pt, pb)), kernel.float(), None,
                           stride=stride)
    if bias is not None:
        # added after the sum, as the JAX package does: a bias folded into
        # the conv may round differently, and the incremental layers must
        # agree bit for bit between the sites they update and the ones they
        # keep from an earlier step
        with span("conv.bias"):
            out.add_(bias.float().reshape(1, -1, 1, 1))
    return out[0] if squeeze else out


def leaky_mask(surface: torch.Tensor, alpha: float) -> torch.Tensor:
    """Leaky-ReLU as a multiplicative float32 mask: 1 or ``alpha`` rounded
    to float32 (Python scalars: no tensor is made on the card, which would
    be a host-to-device copy that waits for the card)."""
    return torch.where(surface > 0, 1.0, float(alpha)).to(torch.float32)


def leaky(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """Leaky-ReLU activation ``max(x, x * alpha)`` (alpha rounded to
    float32, as ``x * jnp.float32(alpha)`` is; a 0-dim CPU tensor acts as a
    scalar beside a tensor on the card).  The maximum goes into the
    buffer of ``x * alpha``, so a call holds two maps of ``x``'s size, not
    three (the window memory model counts on it); under autograd (the
    trainer) it stays out of place."""
    with span("conv.leaky"):
        return activate(x, alpha)


def activate(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """:func:`leaky`'s arithmetic without its span, for a caller inside a
    span of its own (the plain conv epilogue)."""
    y = x * float32_scalar(alpha, "cpu")
    return torch.maximum(x, y) if y.requires_grad else torch.maximum(x, y, out=y)
