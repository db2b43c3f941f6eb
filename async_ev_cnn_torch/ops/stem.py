"""Space-to-depth fusion of a stride-1 3x3 conv + 2x2/2 max-pool pair.

Counterpart of ``async_ev_cnn_tpu/ops/stem.py`` (its docstring derives the
re-blocking).  With the input's 2x2 pixel phases moved into channels
(``Z[c*4 + r*2 + s, u, v] = X[c, 2u+r, 2v+s]``), every output pixel
``(2u+a, 2v+b)`` of the original 3x3 SAME conv is a 3x3 conv tap-set over
Z, so ONE conv of Z with a rearranged ``[4*O, 4*Cin, 3, 3]`` kernel gives
all four pool phases at pool resolution, and the 2x2/2 pool becomes a max
over the 4 phase channels: the full-resolution conv output is never
stored.

The fusion is a re-blocking plus one conv, computed outside any Pallas
kernel in the JAX package; here the conv is ``F.conv2d`` (cuDNN) through
:func:`async_ev_cnn_torch.ops.conv.conv2d_dense`, at the current tier.
s2d only permutes the operands and adds exact zero taps, so an elementwise
operand rounding (TF32) multiplies the same product set as the direct
conv, and fused and direct differ by float32 summation order only.

The JAX package's predicates are ported as options that behave
identically; whether the fusion pays on the H100 is a measurement of its
own (``PERF.md``).
"""

from __future__ import annotations

import numpy as np
import torch

from async_ev_cnn_torch.ops.conv import conv2d_dense, leaky

# Allow the fused pair at a demoted matmul tier, as the JAX package does
# (its ``allow_demoted_precision``): the network reads it each time it
# decides whether a candidate pair fuses.
allow_demoted_precision = True

#: calls of :func:`fused_conv_pool` (one conv each) since the last reset
CALLS = {"fused_conv_pool": 0}


def reset_calls() -> None:
    CALLS["fused_conv_pool"] = 0


def s2d_pair_applicable(conv_spec, pool_spec) -> bool:
    """Structural conditions for the fusion: stride-1 3x3 SAME conv over
    even spatial dims, followed by a 2x2 stride-2 pool, both 'full'."""
    _, h, w = conv_spec.in_shape
    return (
        conv_spec.mode == "full"
        and pool_spec.mode == "full"
        and conv_spec.stride == 1
        and tuple(conv_spec.ksize) == (3, 3)
        and conv_spec.padding == "SAME"
        and h % 2 == 0
        and w % 2 == 0
        and tuple(pool_spec.ksize) == (2, 2)
        and pool_spec.stride == 2
    )


def s2d_pair_wins(conv_spec) -> bool:
    """Fuse only true stems, Cin <= 2: the JAX package's rule, measured on
    its TPU and kept here as the same option."""
    return conv_spec.in_shape[0] <= 2


# tap index tables: _DY[a, r, ey] = the original kernel row dy feeding
# output phase a from input phase r at s2d tap ey (3 = zero-pad slot)
_DY = np.full((2, 2, 3), 3, np.int64)
for _a in range(2):
    for _r in range(2):
        for _e in range(3):
            _dy = 2 * (_e - 1) + _r - _a + 1
            if 0 <= _dy < 3:
                _DY[_a, _r, _e] = _dy


def build_s2d_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """Rearrange an OIHW ``[O, Cin, 3, 3]`` kernel into the s2d kernel
    ``[4*O, 4*Cin, 3, 3]`` (out channel ``(a*2+b)*O + o``, in channel
    ``c*4 + r*2 + s``)."""
    o, cin, kh, kw = kernel.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"the s2d kernel needs a 3x3 kernel, got {kh}x{kw}")
    dy = torch.from_numpy(_DY).to(kernel.device)
    kp = torch.nn.functional.pad(kernel, (0, 1, 0, 1))  # zero tap at index 3
    t1 = kp[:, :, dy, :]        # [O, Cin, a, r, ey, 4]
    t2 = t1[..., dy]            # [O, Cin, a, r, ey, b, s, ex]
    w2 = t2.permute(2, 5, 0, 1, 3, 6, 4, 7)  # a b O c r s ey ex
    return w2.reshape(4 * o, 4 * cin, 3, 3)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """``[..., C, H, W] -> [..., C*4, H/2, W/2]`` with phase-minor channel
    order ``c*4 + r*2 + s``."""
    *lead, c, h, w = x.shape
    n = len(lead)
    z = x.reshape(*lead, c, h // 2, 2, w // 2, 2)
    z = z.permute(*range(n), n, n + 2, n + 4, n + 1, n + 3)  # [..., c, r, s, u, v]
    return z.reshape(*lead, c * 4, h // 2, w // 2)


def fused_conv_pool(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                    alpha: float) -> torch.Tensor:
    """``pool2x2(leaky(conv3x3_SAME(x) + bias))`` via space-to-depth.

    ``x`` is ``[C, H, W]`` or a batch ``[N, C, H, W]`` (even H, W),
    ``kernel`` OIHW ``[O, C, 3, 3]``.  Returns ``[(N,) O, H/2, W/2]``.
    """
    CALLS["fused_conv_pool"] += 1
    o = kernel.shape[0]
    z = space_to_depth(x.float())
    out = conv2d_dense(z, build_s2d_kernel(kernel.float()), None, 1, "SAME")
    # the bias after the sum, tiled over the 4 phases: folded into the conv
    # it would round differently from the direct path's add
    out = out + bias.float().repeat(4).reshape(-1, 1, 1)
    out = leaky(out, alpha)
    *lead, _, h2, w2 = out.shape
    return out.reshape(*lead, 4, o, h2, w2).amax(dim=-4)
