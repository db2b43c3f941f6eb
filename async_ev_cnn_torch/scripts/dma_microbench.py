"""Gather-copy microbenchmark (K7): what one device-memory -> shared-memory
copy costs on the card, in the geometries of the rulebook gathers.

Counterpart of ``examples/dma_microbench.py`` (the TPU's HBM->VMEM DMA
probe; its docstring has the questions).  Grid step ``i`` issues
``n_copies`` copies of one of six shapes (flat / box / rows / box_sp /
rows_sp / box_sm) at ``kh`` 3 or 8, with the example's address formulas,
and the first ``C`` floats of each step's first copy are summed into a
``[1, C]`` output so that the copies cannot be elided.  The kernel is
``csrc/gather_copy.cu`` (``cp.async``); :func:`run_plain` computes the same
output directly, ``sum_i src[y0_i, x0_i, :]`` (``flat[off_i : off_i + C]``
for flat) in grid order, and :func:`run` takes the kernel for tensors on
the card, the plain version for tensors on the CPU.

The per-copy cost is a slope: the time of grid ``g2`` less that of ``g1``
over the extra copies, which cancels the launch overhead.  Times are CUDA
events around single calls, the best of 4 after a warm-up.

    python -m async_ev_cnn_torch.scripts.dma_microbench            # on the card
    python -m async_ev_cnn_torch.scripts.dma_microbench --device cpu  # plain version only
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np
import torch

from async_ev_cnn_torch.ops import cuda_build
from async_ev_cnn_torch.ops.cuda_build import check as _check
from async_ev_cnn_torch.ops.cuda_build import on_cpu as _on_cpu
from async_ev_cnn_torch.ops.cuda_build import ptr as _ptr

N_SITES = 16384
KH, WCOPY, C = 3, 32, 128  # one box copy = 3 * 32 * 128 f32 = 48 KB
H, W = 516, 648
SHAPES = ("flat", "box", "rows", "box_sp", "rows_sp", "box_sm")
# H100 SXM device memory, NVIDIA data sheet
PEAK_BYTES_S = 3.35e12

#: kernel launches since the counts were last reset
LAUNCHES = {"gather_copy": 0}


def reset_launches() -> None:
    LAUNCHES["gather_copy"] = 0


def copy_bytes(shape: str, kh: int, c: int = C) -> int:
    """Bytes of one copy."""
    return 4 * kh * (8 if shape == "box_sm" else WCOPY) * c


def make_inputs(seed: int = 0, device="cpu"):
    """The example's inputs from a seed: ``src [516, 648, 128]`` f32, its
    flattened view, and ``ys, xs [16384]`` int32 corners."""
    rng = np.random.RandomState(seed)
    src = torch.from_numpy(rng.rand(H, W, C).astype(np.float32)).to(device)
    ys = torch.from_numpy(rng.randint(0, H - 8, N_SITES).astype(np.int32)).to(device)
    xs = torch.from_numpy(rng.randint(0, W - WCOPY, N_SITES).astype(np.int32)).to(device)
    return src, src.reshape(-1), ys, xs


def run_plain(src, flat, ys, xs, grid: int, n_copies: int, shape: str, kh: int = KH):
    """Plain PyTorch version of :func:`run`: the first ``C`` floats of each
    step's first copy, added up in grid order -> f32 ``[1, C]``."""
    h, w, c = src.shape
    dev = src.device
    j = torch.arange(grid, dtype=torch.int64, device=dev) * n_copies
    if shape == "flat":
        n_blk = (h * w * c - kh * WCOPY * c) // 1024
        off = ((j * 37) % n_blk) * 1024
        rows = flat[off[:, None] + torch.arange(c, device=dev)[None, :]]
    else:
        if shape in ("box_sp", "rows_sp"):
            jj = j % ys.shape[0]
            y0, x0 = ys[jj].long(), xs[jj].long()
        else:
            y0, x0 = (j * 7) % (h - kh), (j * 13) % (w - WCOPY)
        rows = src[y0, x0]
    out = torch.zeros(c, dtype=torch.float32, device=dev)
    for row in rows:  # in grid order: float additions do not reassociate
        out = out + row
    return out[None]


def run(src, flat, ys, xs, grid: int, n_copies: int, shape: str, kh: int = KH):
    """``grid`` steps of ``n_copies`` copies of ``shape`` at ``kh`` -> f32
    ``[1, C]``.  ``src`` is f32 ``[H, W, C]``, ``flat`` its flattened view,
    ``ys, xs`` int32 corners (in range for ``kh`` rows and ``WCOPY``
    columns)."""
    if shape not in SHAPES:
        raise ValueError(f"shape must be one of {SHAPES}, got {shape!r}")
    if _on_cpu(src, flat, ys, xs):
        return run_plain(src, flat, ys, xs, grid, n_copies, shape, kh)
    dev = src.device
    _check("src", src, torch.float32, dev, 3)
    _check("flat", flat, torch.float32, dev, 1)
    _check("ys", ys, torch.int32, dev, 1)
    _check("xs", xs, torch.int32, dev, 1)
    h, w, c = src.shape
    if flat.numel() != src.numel() or xs.shape != ys.shape or c % 4:
        raise ValueError("flat must hold src's elements, ys and xs one length, "
                         "and C a multiple of 4")
    if kh >= h or WCOPY >= w or grid < 1 or n_copies < 1:
        raise ValueError(f"kh={kh}, grid={grid}, n_copies={n_copies} do not fit "
                         f"src {tuple(src.shape)}")
    rows = torch.empty((grid, c), dtype=torch.float32, device=dev)
    out = torch.empty((1, c), dtype=torch.float32, device=dev)
    cuda_build.launch(
        "gather_copy", "gather_copy", dev, _ptr(src), _ptr(flat), _ptr(ys), _ptr(xs),
        _ptr(rows), _ptr(out),
        *(ctypes.c_int(v) for v in (h, w, c, ys.shape[0], grid, n_copies,
                                    SHAPES.index(shape), kh)))
    LAUNCHES["gather_copy"] += 1
    return out


def time_grid(inputs, grid: int, n_copies: int, shape: str, kh: int) -> float:
    """Best of 4 CUDA-event times (seconds) of one call, after a warm-up."""
    run(*inputs, grid, n_copies, shape, kh)
    best = float("inf")
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        run(*inputs, grid, n_copies, shape, kh)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def check_against_plain(inputs, grid: int = 4, n_copies: int = 2) -> list:
    """Each (shape, kh) through :func:`run` against :func:`run_plain` at
    ``grid`` steps of ``n_copies`` copies; returns ``(shape, kh, max |run -
    plain|)`` rows.  At the slope's grids the corners of box_sp / rows_sp
    wrap around ``ys, xs`` and flat's offsets around the source."""
    out = []
    for shape in SHAPES:
        for kh in (3, 8):
            got = run(*inputs, grid, n_copies, shape, kh)
            want = run_plain(*inputs, grid, n_copies, shape, kh)
            out.append((shape, kh, float((got - want).abs().max())))
    return out


def slope_table(inputs, n_copies: int = 8, g1: int = 4096, g2: int = 16384) -> list:
    """The slope rows for every (shape, kh): dicts with the per-copy and
    per-row times (µs), GB/s, its share of the card's memory rate, and the
    two grids' times (ms)."""
    rows = []
    for shape in SHAPES:
        for kh in (3, 8):
            t1 = time_grid(inputs, g1, n_copies, shape, kh)
            t2 = time_grid(inputs, g2, n_copies, shape, kh)
            per = (t2 - t1) / ((g2 - g1) * n_copies)
            gbs = copy_bytes(shape, kh) / per / 1e9
            rows.append({"shape": shape, "kh": kh, "us_per_copy": per * 1e6,
                         "us_per_row": per * 1e6 / kh, "gb_s": gbs,
                         "share": gbs * 1e9 / PEAK_BYTES_S,
                         "t_g1_ms": t1 * 1e3, "t_g2_ms": t2 * 1e3})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="torch device; the card ('cuda') when not given")
    p.add_argument("--n_copies", type=int, default=8)
    p.add_argument("--g1", type=int, default=4096)
    p.add_argument("--g2", type=int, default=16384)
    args = p.parse_args(argv)

    from async_ev_cnn_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    inputs = make_inputs(0, dev)
    if dev.type == "cpu":
        for shape in SHAPES:
            for kh in (3, 8):
                out = run(*inputs, 4, 2, shape, kh)
                assert bool(torch.isfinite(out).all()), (shape, kh)
        print("plain-version semantics OK (no timing on the CPU)")
        return 0
    bad = [r for grid, n in ((4, 2), (args.g2, args.n_copies))
           for r in check_against_plain(inputs, grid, n) if r[2] != 0.0]
    if bad:
        print(f"ERROR: the kernel differs from its plain version: {bad}")
        return 1
    print(f"{torch.cuda.get_device_name(dev)}: row = [{WCOPY}, {C}] f32 = "
          f"{WCOPY * C * 4 // 1024} KB (box_sm: [8, {C}]); copy = kh rows; "
          f"{args.n_copies} copies a step, slope between grids {args.g1} and {args.g2}")
    print(f"{'shape':8s} {'kh':>3s} {'us/copy':>9s} {'us/row':>8s} {'GB/s':>8s} {'of peak':>8s}")
    for r in slope_table(inputs, args.n_copies, args.g1, args.g2):
        print(f"{r['shape']:8s} {r['kh']:3d} {r['us_per_copy']:9.4f} {r['us_per_row']:8.4f} "
              f"{r['gb_s']:8.1f} {100 * r['share']:7.1f}%   (t_g1={r['t_g1_ms']:.3f} ms "
              f"t_g2={r['t_g2_ms']:.3f} ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
