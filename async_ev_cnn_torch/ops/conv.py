"""Dense 2-D convolution with TF-compatible padding.

Counterpart of ``async_ev_cnn_tpu/ops/conv.py``.  The TF SAME pad formulas
are copied verbatim; the conv is ``F.conv2d`` on the TF-padded input.

Matmul tier: the port supports ``highest`` only, which is IEEE float32 in
both cuDNN (convs) and cuBLAS (the fc tail).  PyTorch's default lets cuDNN
run float32 convs in TF32, which keeps about three decimal digits and
would quietly break the <= 1e-4 async-vs-dense contract, so
:func:`set_matmul_precision` turns TF32 off in both, and
:func:`conv2d_dense` applies the tier again before every conv on the card
(the tier is process-wide here as in the JAX package).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from async_ev_cnn_torch.ops.numerics import float32_scalar

_TIERS = ("highest", "high", "default")
_MATMUL_PRECISION = "highest"


def set_matmul_precision(name: str) -> None:
    """Set the process-wide conv/GEMM precision tier.

    Only ``'highest'`` exists in this slice of the port; ``'high'`` and
    ``'default'`` raise until an H100 drift run fixes their Hopper mapping
    (TF32, bf16 or 3xTF32)."""
    global _MATMUL_PRECISION
    if name not in _TIERS:
        raise ValueError(
            f"matmul precision must be one of {sorted(_TIERS)}, got {name!r}")
    if name != "highest":
        raise NotImplementedError(
            f"matmul precision {name!r} waits for the port's precision-tier "
            "slice; only 'highest' (IEEE float32) is supported")
    _MATMUL_PRECISION = name
    _apply_tier()


def matmul_precision() -> str:
    return _MATMUL_PRECISION


def _apply_tier() -> None:
    # 'highest': no TF32 anywhere
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


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
    """Explicit pads for 'SAME' or 'VALID' padding."""
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding == "SAME":
        return tf_same_pads(in_h, in_w, k_h, k_w, stride)
    raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")


def conv_out_shape(in_h: int, in_w: int, k_h: int, k_w: int, stride: int, padding: str):
    """Output spatial shape."""
    if padding == "VALID":
        return (in_h - k_h) // stride + 1, (in_w - k_w) // stride + 1
    if padding == "SAME":
        return -(-in_h // stride), -(-in_w // stride)
    raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")


def conv2d_dense(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None,
    stride: int = 1,
    padding: str = "VALID",
) -> torch.Tensor:
    """Dense conv of ``x`` ``[C, H, W]`` or ``[N, C, H, W]`` with ``kernel``
    ``[O, I, kh, kw]`` (OIHW) and the TF pads of ``padding``."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    _, _, in_h, in_w = x.shape
    _, _, k_h, k_w = kernel.shape
    (pt, pb), (pl, pr) = conv_pads(in_h, in_w, k_h, k_w, stride, padding)
    if x.is_cuda:
        _apply_tier()
    x = x.float()
    if pt == pb and pl == pr:
        # symmetric pads (every stride-1 odd kernel): let the conv pad
        # instead of materialising a padded copy of the input
        out = F.conv2d(x, kernel.float(), bias, stride=stride, padding=(pt, pl))
    else:
        out = F.conv2d(F.pad(x, (pl, pr, pt, pb)), kernel.float(), bias,
                       stride=stride)
    return out[0] if squeeze else out


def leaky_mask(surface: torch.Tensor, alpha: float) -> torch.Tensor:
    """Leaky-ReLU as a multiplicative mask."""
    one = torch.ones((), dtype=torch.float32, device=surface.device)
    return torch.where(surface > 0, one, one.new_tensor(alpha))


def leaky(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """Leaky-ReLU activation ``max(x, x * alpha)`` (alpha rounded to
    float32, as ``x * jnp.float32(alpha)`` is; a 0-dim CPU tensor acts as a
    scalar beside a tensor on the card)."""
    return torch.maximum(x, x * float32_scalar(alpha, "cpu"))
