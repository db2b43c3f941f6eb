"""Surface-scan kernels: all T chunk-boundary surfaces of the leaky
integration layer in one pass over the pixels.

Counterpart of ``async_ev_cnn_tpu/ops/pallas_scan.py``.  Two functions, each
with a hand-written CUDA kernel (``csrc/surface_scan.cu``) and a plain
PyTorch version of the same arithmetic:

* :func:`surface_scan_events` (JAX ``surface_scan_events_pallas``) reads
  each chunk's deduplicated winner list — a flat ``C*H*W`` pixel index and
  ``dt = last_ts - ts`` per event, ``-1`` for losers and padding — and
  places the winners onto the surface;
* :func:`surface_scan_tsmap` (JAX ``surface_scan_pallas``) reads a
  per-chunk int32 timestamp map, the sentinel meaning no event.

Both are bit-identical to iterating ``ops.integrate.integrate_step``.  A
wrapper runs its plain version for tensors on the CPU, and the kernel for
tensors on the card — or raises; it never falls back.  ``LAUNCHES`` counts
kernel launches per function, so a run can show that it went through the
kernels.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from async_ev_cnn_torch.ops import cuda_build
from async_ev_cnn_torch.ops.cuda_build import check as _check
from async_ev_cnn_torch.ops.cuda_build import on_cpu as _on_cpu
from async_ev_cnn_torch.ops.cuda_build import ptr as _ptr
from async_ev_cnn_torch.ops.numerics import float32_scalar, snap

#: kernel launches per wrapper since the counts were last reset
LAUNCHES = {"surface_scan_events": 0, "surface_scan_tsmap": 0}

#: int32 timestamp meaning "no event at this pixel" (the JAX package's value)
TS_SENTINEL_VALUE = -(2**31) + 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _clamp0(s: torch.Tensor) -> torch.Tensor:
    # select form, as the reference: zeros come out +0.0
    return torch.where(s <= 0, torch.zeros((), dtype=s.dtype, device=s.device), s)


def surface_scan_events_plain(surface, pix, dt, d, leak: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`surface_scan_events`: a loop over T
    with ``index_put_`` of each chunk's winners."""
    c, h, w = surface.shape
    t = pix.shape[0]
    p = c * h * w
    leak_f = float32_scalar(leak, surface.device)
    s = surface.reshape(p)
    out = torch.empty((t, p), dtype=torch.float32, device=surface.device)
    for i in range(t):
        s1 = _clamp0(s - d[i])
        # losers, padding and out-of-range indices land in a spare slot p
        # that is dropped: no boolean indexing, so no host sync on the card
        hit = (pix[i] >= 0) & (pix[i] < p)
        idx = torch.where(hit, pix[i], p).long()
        contrib = torch.zeros(p + 1, dtype=torch.float32, device=surface.device)
        contrib.index_put_((idx,), 1 - snap(dt[i].float() * leak_f))
        s = _clamp0(s1 + contrib[:p])
        out[i] = s
    return out.reshape(t, c, h, w)


def surface_scan_tsmap_plain(surface, ts_map, d, last_ts, leak: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`surface_scan_tsmap`."""
    t = ts_map.shape[0]
    leak_f = float32_scalar(leak, surface.device)
    s = surface
    out = torch.empty((t, *surface.shape), dtype=torch.float32,
                      device=surface.device)
    for i in range(t):
        s1 = _clamp0(s - d[i])
        tm = ts_map[i]
        contrib = 1 - snap((last_ts[i] - tm).float() * leak_f)
        s = _clamp0(s1 + torch.where(
            tm > TS_SENTINEL_VALUE, contrib,
            torch.zeros((), dtype=torch.float32, device=s.device)))
        out[i] = s
    return out


def _launch(fn_name: str, device, *args) -> None:
    cuda_build.launch("surface_scan", fn_name, device, *args)
    LAUNCHES[fn_name] += 1


def surface_scan_events(surface, pix, dt, d, leak: float) -> torch.Tensor:
    """All T chunk-boundary surfaces from per-event winner lists.

    Args:
      surface: f32 ``[C, H, W]`` surface at the window start.
      pix, dt: int32 ``[T, E]`` winner lists from
        :func:`async_ev_cnn_torch.ops.integrate.chunk_event_updates`: the
        flat ``C*H*W`` pixel index (``-1``: no event) and ``dt``.
      d: f32 ``[T]`` per-chunk snapped leak decrements.
      leak: leak rate per microsecond (applied as a float32).

    Returns:
      f32 ``[T, C, H, W]`` surfaces after each chunk — bit-identical to
      iterating ``integrate_step``.
    """
    if _on_cpu(surface, pix, dt, d):
        return surface_scan_events_plain(surface, pix, dt, d, leak)
    dev = surface.device
    _check("surface", surface, torch.float32, dev, 3)
    _check("pix", pix, torch.int32, dev, 2)
    _check("dt", dt, torch.int32, dev, 2)
    _check("d", d, torch.float32, dev, 1)
    c, h, w = surface.shape
    t, e = pix.shape
    if dt.shape != pix.shape or d.shape[0] != t:
        raise ValueError(f"shape mismatch: pix {tuple(pix.shape)}, dt "
                         f"{tuple(dt.shape)}, d {tuple(d.shape)}")
    out = torch.empty((t, c, h, w), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out  # nothing to compute: no launch, nothing counted
    _launch("surface_scan_events", dev, _ptr(surface), _ptr(pix), _ptr(dt),
            _ptr(d), _ptr(out), ctypes.c_int(t), ctypes.c_int(e),
            ctypes.c_int(c * h * w), ctypes.c_float(np.float32(leak)))
    return out


def surface_scan_tsmap(surface, ts_map, d, last_ts, leak: float) -> torch.Tensor:
    """All T chunk-boundary surfaces from per-chunk timestamp maps.

    Args:
      surface: f32 ``[C, H, W]`` surface at the window start.
      ts_map: int32 ``[T, C, H, W]`` per-chunk per-pixel max event
        timestamp (``TS_SENTINEL_VALUE`` where the chunk has no event).
      d: f32 ``[T]`` per-chunk snapped leak decrements.
      last_ts: int32 ``[T]`` per-chunk running last event timestamps.
      leak: leak rate per microsecond (applied as a float32).

    Returns:
      f32 ``[T, C, H, W]`` surfaces after each chunk — bit-identical to
      iterating ``integrate_step``.
    """
    if _on_cpu(surface, ts_map, d, last_ts):
        return surface_scan_tsmap_plain(surface, ts_map, d, last_ts, leak)
    dev = surface.device
    _check("surface", surface, torch.float32, dev, 3)
    _check("ts_map", ts_map, torch.int32, dev, 4)
    _check("d", d, torch.float32, dev, 1)
    _check("last_ts", last_ts, torch.int32, dev, 1)
    t = ts_map.shape[0]
    if (ts_map.shape[1:] != surface.shape or d.shape[0] != t
            or last_ts.shape[0] != t):
        raise ValueError(f"shape mismatch: surface {tuple(surface.shape)}, "
                         f"ts_map {tuple(ts_map.shape)}, d {tuple(d.shape)}, "
                         f"last_ts {tuple(last_ts.shape)}")
    out = torch.empty((t, *surface.shape), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out  # nothing to compute: no launch, nothing counted
    _launch("surface_scan_tsmap", dev, _ptr(surface), _ptr(ts_map), _ptr(d),
            _ptr(last_ts), _ptr(out), ctypes.c_int(t),
            ctypes.c_int(surface.numel()), ctypes.c_float(np.float32(leak)))
    return out
