"""L1: the LayerNorm of RVT's tokens over their channels, with the window or
grid partition of the attention that reads them folded into its store.

No Pallas kernel stands behind it: the JAX package runs no transformer.
The hand-written kernel is ``csrc/layer_norm.cu`` (the source says what
bounds it and how it is laid out); its plain version,
:func:`layer_norm_plain`, is ``F.layer_norm`` and the partition's copy
(:func:`partition`).  The two agree to float32's rounding: the kernel
sums each token's channels in a warp's order, PyTorch's LayerNorm by
Welford's update.

A call runs inside one ``norm.l1`` span.  The wrapper runs the plain
version for tensors on the CPU and the kernel for tensors on the card, or
raises; it takes no gradient.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from async_ev_cnn_torch.ops import cuda_build
from async_ev_cnn_torch.ops.cuda_build import on_cpu as _on_cpu
from async_ev_cnn_torch.ops.cuda_build import ptr as _ptr
from async_ev_cnn_torch.utils.profiling import span

#: kernel launches since the counts were last reset
LAUNCHES = {"layer_norm": 0}
#: the partitions' codes in the kernel
KINDS = {None: 0, "win": 1, "grid": 2}
#: the widest token the kernel takes
MAX_C = 512


def partition(x: torch.Tensor, ph: int, pw: int, kind: str) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B * n, ph * pw, C]`` partitions of ``ph x pw``
    tokens: 'win' the contiguous tiles (local attention), 'grid' the
    tokens ``H / ph`` rows and ``W / pw`` columns apart (dilated, global
    attention); each partition in row-major order."""
    b, h, w, c = x.shape
    if kind == "win":
        x = x.reshape(b, h // ph, ph, w // pw, pw, c).permute(0, 1, 3, 2, 4, 5)
    else:
        x = x.reshape(b, ph, h // ph, pw, w // pw, c).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(-1, ph * pw, c)


def layer_norm_plain(x, gamma, beta, eps: float, kind=None, ph: int = 0, pw: int = 0):
    """Plain PyTorch version of :func:`layer_norm`."""
    y = x if gamma is None else F.layer_norm(x, (x.shape[-1],), gamma, beta, eps)
    return y.contiguous() if kind is None else partition(y, ph, pw, kind)


def layer_norm(x: torch.Tensor, gamma, beta, eps: float, kind=None, ph: int = 0,
               pw: int = 0) -> torch.Tensor:
    """``x`` f32 ``[N, H, W, C]`` at any strides whose pixels merge
    (channels-last, or a permuted channels-first map) -> its LayerNorm over
    ``C`` (``gamma``, ``beta`` ``[C]``; ``gamma=None``: ``x`` unnormed),
    contiguous: ``[N, H, W, C]`` for ``kind=None``, else the ``kind``
    partitions ``[N * n, ph * pw, C]`` (:func:`partition`)."""
    n, h, w, c = x.shape
    if kind not in KINDS or kind and (h % ph or w % pw):
        raise ValueError(f"the LayerNorm partitions 'win' or 'grid' tiles of a frame, got "
                         f"{kind!r} with {ph}x{pw} over {h}x{w}")
    with span("norm.l1"):
        if _on_cpu(x, *(t for t in (gamma, beta) if t is not None)):
            return layer_norm_plain(x, gamma, beta, eps, kind, ph, pw)
        if x.dtype != torch.float32 or c > MAX_C or c % 4:
            raise ValueError(f"the LayerNorm kernel takes float32 tokens of a multiple of 4 "
                             f"channels, at most {MAX_C}, got {x.dtype} and {c}")
        sn, sh, sw, sc = x.stride()
        if sh != w * sw or not (sw == 1 or sc == 1):
            x = x.contiguous()
            sn, sh, sw, sc = x.stride()
        out = torch.empty((n * h * w, c), dtype=torch.float32, device=x.device)
        if out.numel():
            norm = gamma is not None
            g = gamma.float().contiguous() if norm else out
            b = beta.float().contiguous() if norm else out
            cuda_build.launch("layer_norm", "layer_norm", x.device, _ptr(x), _ptr(g), _ptr(b),
                              _ptr(out), ctypes.c_longlong(n * h * w), ctypes.c_int(h),
                              ctypes.c_int(w), ctypes.c_int(c), ctypes.c_longlong(sn),
                              ctypes.c_longlong(sw), ctypes.c_longlong(sc),
                              ctypes.c_int(KINDS[kind]), ctypes.c_int(ph), ctypes.c_int(pw),
                              ctypes.c_int(norm), ctypes.c_float(eps))
            LAUNCHES["layer_norm"] += 1
        return out.view(n, h, w, c) if kind is None else out.view(-1, ph * pw, c)
