"""Fused conv + pool (C1): ``maxpool2x2(leaky(conv3x3_SAME(x, w) + b))``
over any number of input channels, in IEEE float32, in one kernel that
writes only the pooled map.

It replaces no TPU kernel: the JAX package leaves a conv, its bias, the
activation and ``reduce_window`` to XLA, which fuses them itself.  In the
port it runs the 'full' networks' 2x2/2-pooled 3x3 SAME stride-1 convs on
the card, other than the one-channel stem, in place of cuDNN's conv and
the pooled epilogue wherever it gives their numbers bit for bit
(``layers/conv_stack.py`` decides: it sums in cuDNN's implicit-GEMM order,
so it does wherever cuDNN runs that algorithm).  The
hand-written kernel is ``csrc/conv_pool.cu`` (its source gives the FLOP
bound and the design).  A wrapper runs its plain version for an input on
the CPU and the kernel for an input on the card, or raises; a call runs
inside one ``conv.fused_pool`` span.  ``LAUNCHES`` counts kernel launches.

The kernel takes the weights packed K-major, ``[C_pad, 9, O_pad]``
(:func:`pack_weights`): made once per weight tensor and kept by the caller
(:func:`packed_weights`), so a call repacks nothing.

Numerics.  Each output of the conv is a sum of ``K = 9 * C_in`` float32
products.  The kernel sums them from zero by FMA, input channel by input
channel and tap by tap: K roundings, each at most ``u = 2**-24`` of a
partial sum, and no partial sum exceeds ``A``, the sum of the terms'
magnitudes (``conv(|x|, |w|)``), so the kernel's sum is within ``K * u *
A`` of the exact one (to first order).  The plain version,
:func:`conv_pool_plain`, sums in float64, whose error (``K * 2**-53 *
A``) is negligible, and rounds the window's max to float32 once (``u`` of
it, at most ``u * A``).  Both then take the same 2x2 max (which moves
neither error: ``|max a - max b| <= max |a - b|``), one rounded add of
the bias and the activation (each a rounding of ``u`` of the result, and
the activation's ``alpha <= 1`` shrinks a difference).  So, to first
order, ``|C1 - plain| <= u * ((K + 1) * A_max + 2 * (|plain| + |b|))``,
``A_max`` the window's largest ``A``, and :func:`c1_bound` holds the two
within ``C1_TOL * (K * A_max + |plain| + |b|)``, :data:`C1_TOL` =
``2 * u``, which covers that with room for the second-order terms.  The
same bound holds the 'pooled' route's layers (cuDNN's or the CPU's float32
conv, at most ``K * u * A`` from the exact sum in any order, then the
epilogue) to the plain version.  In practice the roundings are
independent and the difference is about ``sqrt(K) * u`` of ``A``.

That bound is a worst case, about 1e-3 of ``1 + |out|`` at K = 1,152, so
a kernel in a lower precision passes it too (TF32 keeps 10 mantissa bits,
a relative error near 5e-4).  What holds C1 to float32 is the comparison
with cuDNN's float32 conv and the pooled epilogue, within
:data:`LIBRARY_REL` = 1e-6 of their largest value: the chip tests make it
at the route's shapes, and the card's plan makes it on every pair it
probes (``layers/conv_stack.py``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from async_ev_cnn_torch.ops import cuda_build
from async_ev_cnn_torch.ops.conv import activate
from async_ev_cnn_torch.ops.cuda_build import check as _check
from async_ev_cnn_torch.ops.cuda_build import on_cpu as _on_cpu
from async_ev_cnn_torch.ops.cuda_build import ptr as _ptr
from async_ev_cnn_torch.ops.epilogue import pools_exactly
from async_ev_cnn_torch.utils.profiling import span

#: kernel launches since the counts were last reset
LAUNCHES = {"conv_pool": 0}

#: the kernel's output-channel tiles (its template instances) and the
#: input channels a stage of each one's ring (csrc/conv_pool.cu Tile::kChunk)
CHUNKS = {32: 4, 64: 8}
O_TILES = tuple(CHUNKS)

#: C1 against its plain version: ``|C1 - plain| <= C1_TOL * (K * A_max +
#: |plain| + |b|)`` (the module docstring derives it; :func:`c1_bound`)
C1_TOL = 2.0 ** -23

#: C1 against cuDNN's float32 conv and the pooled epilogue (the 'pooled'
#: route): ``|C1 - library| <= LIBRARY_REL * max|library|``.  A TF32 or
#: bf16-input kernel, which :func:`c1_bound` lets pass, fails it
LIBRARY_REL = 1e-6


class Packed(NamedTuple):
    """A conv's weights as the kernel takes them: ``w`` f32 ``[C_pad, 9,
    O_pad]`` and ``bias`` f32 ``[O_pad]``, zero past ``c_out``, for the
    output-channel tile ``o_tile``."""

    w: torch.Tensor
    bias: torch.Tensor
    c_out: int
    o_tile: int


def reset_launches() -> None:
    LAUNCHES["conv_pool"] = 0


def o_tile(c_out: int) -> int:
    """The kernel's output-channel tile for ``c_out`` channels: the smaller
    instance where it holds them all, so a narrow conv runs a block of
    more windows in place of idle channels."""
    return O_TILES[0] if c_out <= O_TILES[0] else O_TILES[1]


def pack_weights(kernel: torch.Tensor, bias: torch.Tensor) -> Packed:
    """An OIHW ``[O, C, 3, 3]`` ``kernel`` and its ``bias`` as the kernel
    takes them, on their device: ``w[c, 3 * dy + dx, o] = kernel[o, c, dy,
    dx]``, zero past C and O up to a whole chunk and tile of the instance
    :func:`o_tile` picks."""
    o, c, kh, kw = kernel.shape
    if (kh, kw) != (3, 3) or bias.shape != (o,):
        raise ValueError(f"the fused conv + pool takes a [O, C, 3, 3] kernel and a [O] bias, "
                         f"got {tuple(kernel.shape)} and {tuple(bias.shape)}")
    tile = o_tile(o)
    c_pad, o_pad = -(-c // CHUNKS[tile]) * CHUNKS[tile], -(-o // tile) * tile
    w = torch.zeros(c_pad, 9, o_pad, dtype=torch.float32, device=kernel.device)
    w[:c, :, :o] = kernel.detach().float().permute(1, 2, 3, 0).reshape(c, 9, o)
    b = torch.zeros(o_pad, dtype=torch.float32, device=bias.device)
    b[:o] = bias.detach().float()
    return Packed(w, b, o, tile)


def packed_weights(cache: dict, key, kernel: torch.Tensor, bias: torch.Tensor) -> Packed:
    """:func:`pack_weights` of ``kernel`` and ``bias``, made once per pair
    of weight tensors and kept in ``cache`` under ``key``
    (:func:`~async_ev_cnn_torch.ops.cuda_build.weights_cache`: made anew
    when either tensor, its version or its storage changes, and at every
    call for an inference tensor)."""
    return cuda_build.weights_cache(cache, key, pack_weights, kernel, bias)


def conv_pool_plain(x, kernel, bias, alpha: float = 0.1):
    """Plain PyTorch version of :func:`conv_pool`: the conv summed in
    float64, the 2x2 max rounded to float32 once, then the kernel's float32
    bias add and activation ``max(v, alpha * v)``."""
    s = F.conv2d(x.double(), kernel.double(), padding=1)
    m = F.max_pool2d(s, 2).float()
    return activate(m + bias.float().reshape(-1, 1, 1), alpha)


def c1_bound(x, kernel, bias, plain):
    """The largest ``|C1 - plain|`` the module docstring allows at each
    pooled output: ``C1_TOL * (K * A_max + |plain| + |b|)``.  A worst case
    that a TF32 kernel passes too: :data:`LIBRARY_REL` is the check of
    float32."""
    k = 9 * kernel.shape[1]
    a_max = F.max_pool2d(F.conv2d(x.double().abs(), kernel.double().abs(), padding=1), 2)
    return C1_TOL * (k * a_max + plain.double().abs()
                     + bias.double().abs().reshape(-1, 1, 1))


def conv_pool(x, kernel, bias, alpha: float = 0.1, packed: Packed | None = None):
    """``x`` f32 ``[N, C_in, H, W]`` (H, W even), an OIHW ``[C_out, C_in, 3,
    3]`` ``kernel`` and its ``bias`` -> f32 ``[N, C_out, H/2, W/2]``, for
    ``0 < alpha <= 1``.  On the card the kernel reads ``packed`` (the
    weights packed once, :func:`packed_weights`), or packs them first."""
    if x.dim() != 4 or x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"the fused conv + pool takes x [N, C, H, W] with even H and W, "
                         f"got {tuple(x.shape)}")
    if kernel.shape[1:] != (x.shape[1], 3, 3) or bias.shape != kernel.shape[:1]:
        raise ValueError(f"the fused conv + pool takes a [O, {x.shape[1]}, 3, 3] kernel and "
                         f"a [O] bias, got {tuple(kernel.shape)} and {tuple(bias.shape)}")
    if not pools_exactly(alpha):
        raise ValueError(f"the fused conv + pool pools before the activation, exact only for "
                         f"0 < alpha <= 1, got {alpha}")
    with span("conv.fused_pool"):
        if _on_cpu(x, kernel, bias):
            return conv_pool_plain(x, kernel, bias, alpha)
        dev = x.device
        packed = packed or pack_weights(kernel, bias)
        n, c_in, h, w = x.shape
        if packed.o_tile not in O_TILES:
            raise ValueError(f"the kernel has no {packed.o_tile}-channel tile")
        c_pad = -(-c_in // CHUNKS[packed.o_tile]) * CHUNKS[packed.o_tile]
        o_pad = -(-packed.c_out // packed.o_tile) * packed.o_tile
        _check("x", x, torch.float32, dev, 4)
        _check("w", packed.w, torch.float32, dev, 3)
        _check("bias", packed.bias, torch.float32, dev, 1)
        if (packed.c_out != kernel.shape[0] or packed.w.shape != (c_pad, 9, o_pad)
                or packed.bias.shape != (o_pad,)):
            raise ValueError(f"packed weights {tuple(packed.w.shape)} (tile {packed.o_tile}) "
                             f"do not fit a [{packed.c_out}, {c_in}, 3, 3] kernel")
        out = torch.empty((n, packed.c_out, h // 2, w // 2), dtype=torch.float32, device=dev)
        if out.numel() == 0:
            return out  # nothing to compute: no launch, nothing counted
        cuda_build.launch("conv_pool", "conv_pool", dev, _ptr(x), _ptr(packed.w),
                          _ptr(packed.bias), _ptr(out),
                          *(ctypes.c_int(v) for v in (n, c_in, h, w, packed.c_out,
                                                      packed.o_tile)),
                          ctypes.c_float(alpha))
        LAUNCHES["conv_pool"] += 1
        return out
