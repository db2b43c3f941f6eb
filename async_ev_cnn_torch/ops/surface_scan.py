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

Both are bit-identical to iterating ``ops.integrate.integrate_step``.  K1
is two launches, a binning pass and the scan, cut by
:func:`scan_events_plan`; K2 one, cut by :func:`scan_tsmap_plan`.  A
wrapper runs its plain version for tensors on the CPU, and the kernel for
tensors on the card — or raises; it never falls back.  ``LAUNCHES`` counts
wrapper calls that launched their kernels, so a run can show that it went
through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

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

# K1's shape (csrc/surface_scan.cu): pixels a tile (one scan block, a
# thread a pixel), chunks a window
SCAN_TILE = 128
SCAN_WINDOW = 64
# K2's: pixels a tile (one warp, a thread a pixel), chunks a window (the
# ts values a thread prefetches into registers)
TSMAP_TILE = 32
TSMAP_WINDOW = 32
#: shared memory one block of the H100 may use
SMEM_LIMIT_BYTES = 232_448


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


class ScanEventsPlan(NamedTuple):
    """How one K1 call is cut: ``n_tiles`` tiles of ``tile`` pixels (the
    last one ragged), each a block of the scan walking T in ``n_windows``
    windows of ``window`` chunks (the last one ragged); the binning pass's
    dynamic shared memory (a bucket start per tile, and one more); and the
    int32 workspace: ``[T, E]`` binned entries of two words, then
    ``[T, n_tiles + 1]`` bucket offsets."""
    tile: int
    window: int
    n_tiles: int
    n_windows: int
    bin_smem_bytes: int
    workspace: int


def scan_events_plan(t: int, e: int, p: int) -> ScanEventsPlan:
    """K1's launch plan for ``T = t`` chunks of ``E = e`` winners over ``P =
    p`` pixels.  The tile is 128 pixels: a block of 4 warps, a thread a
    pixel, so that the eFCN's 35,840 pixels give 280 blocks, about two an
    SM of the H100's 132 and all resident at once (the scan's parallelism
    is its pixels; time is serial).  The window is 64 chunks: its
    ``[64, 128]`` float contribution array is 32 KB, so a block's static
    shared memory stays under 48 KB and six blocks could share an SM, and
    a T=200 dispatch crosses 4 windows, 8 barriers a block.  Raises where
    the binning pass's buckets would not fit a block's shared memory."""
    n_tiles = -(-p // SCAN_TILE)
    bin_smem = 4 * (n_tiles + 1)
    if bin_smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"{p} pixels make {n_tiles} tiles: their bucket starts "
                         f"({bin_smem} B) exceed a block's shared memory")
    return ScanEventsPlan(SCAN_TILE, SCAN_WINDOW, n_tiles, -(-t // SCAN_WINDOW), bin_smem,
                          2 * t * e + t * (n_tiles + 1))


class ScanTsmapPlan(NamedTuple):
    """How one K2 call is cut: ``n_tiles`` tiles of ``tile`` pixels (the
    last one ragged), each a one-warp block walking T in ``n_windows``
    windows of ``window`` chunks (the last one ragged), the next window's
    ts values loaded while this one is walked."""
    tile: int
    window: int
    n_tiles: int
    n_windows: int


def scan_tsmap_plan(t: int, p: int) -> ScanTsmapPlan:
    """K2's launch plan for ``T = t`` chunks over ``P = p`` pixels.  A tile
    is one warp of 32 pixels, so the eFCN's 35,840 pixels make 1,120
    blocks, 8 or 9 an SM of the H100's 132, all resident at once (one more
    or less an SM is an eighth of its work, where 128-pixel tiles gave 2 or
    3).  A window is 32 chunks: 32 ts values a thread in flight, about 35
    KB an SM, above the 25 KB that 3.35 TB/s at a microsecond's latency
    needs; a lane holds one chunk's scalars."""
    return ScanTsmapPlan(TSMAP_TILE, TSMAP_WINDOW, -(-p // TSMAP_TILE), -(-t // TSMAP_WINDOW))


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
    plan = scan_events_plan(t, e, c * h * w)
    if plan.workspace >= 2**31:
        raise ValueError("K1 indexes its binned winner lists with int32")
    work = torch.empty(plan.workspace, dtype=torch.int32, device=dev)
    _launch("surface_scan_events", dev, _ptr(surface), _ptr(pix), _ptr(dt),
            _ptr(d), _ptr(out), _ptr(work), ctypes.c_int(t), ctypes.c_int(e),
            ctypes.c_int(c * h * w), ctypes.c_float(np.float32(leak)),
            *(ctypes.c_int(v) for v in (plan.tile, plan.window, plan.n_tiles,
                                        plan.bin_smem_bytes)))
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
    plan = scan_tsmap_plan(t, surface.numel())
    _launch("surface_scan_tsmap", dev, _ptr(surface), _ptr(ts_map), _ptr(d),
            _ptr(last_ts), _ptr(out), ctypes.c_int(t),
            ctypes.c_int(surface.numel()), ctypes.c_float(np.float32(leak)),
            *(ctypes.c_int(v) for v in (plan.tile, plan.window, plan.n_tiles)))
    return out
