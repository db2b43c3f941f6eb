#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (async_ev_cnn_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one line each on standard output:

1. environment: the card, its power limit, torch/CUDA versions, TF32 off;
2. build: both surface-scan kernels from async_ev_cnn_torch/csrc with nvcc;
3. kernels: each kernel against its plain PyTorch version bit for bit at
   the eFCN's full width (160x224, T=200 chunks of 256 events), against
   each other, on a 2-channel ragged case, on a large-dt case, and against
   iterating integrate_step; with median times and the memory bound;
4. path: the eFCN from configs/efcn_event.yml with seeded random weights,
   served by StreamingPipeline (plain wire, T=200 chunks per dispatch,
   batched head.decode, the default 'events' engine: K1) for 16
   dispatches; then the ts-map engine's path (K2), one full-width
   EventNetwork.scan_parallel(integrate_engine='tsmap') dispatch.  The
   launch counts are set to 0 just before each path and read just after
   it, and each kernel's count is its own path's;
5. card against CPU: one T=16 dispatch by the same port on the card and on
   the CPU: surfaces bit-equal, grid outputs within 1e-4;
6. profile: one more dispatch under torch.profiler, with the device-busy
   share of its wall time and the kernels that take the most device time.

Then the incremental (sequential) engine, the eFCN in conv_mode
'sparse_pallas' on a clustered stream (events around a drifting centre,
radius 8, ts gaps 1..14 us, the JAX benchmark's clustered_stream):

7. rulebook kernels: K3 (rulebook_gather_gemm_blocks) at every conv layer's
   shapes, its 1x8 blocks taken from that layer's real active mask at its
   block capacity, and K4 (rulebook_gather_gemm) at stride 2 on conv2's
   shapes, each against its plain version within 1e-5 * (1 + max |plain|)
   (float32 sums of up to 9 * 512 terms in another order); with median
   times, the plain versions' times, the memory/FFMA bound and the time of
   the layer's dense [2, C, H, W] conv pair (the crossover reference);
8. path: YoloEventTorch.scan over 64 chunks of 256 events (the sequential
   engine, not all layers 'full'), the counts set to 0 just before and
   read just after: events/s, ms/chunk, and per conv layer the K3
   launches, dense fallbacks and host reads; K3 must launch at conv1 on
   every chunk, and the grids must lie within 1e-4 of the same run in
   conv_mode 'dense';
9. gate: run_equivalence at full width in 'sparse_pallas' and in 'dense'
   (30 steps of 200 uniform events, max_dt 30): every layer within 1e-4 of
   the dense oracle;
10. K4's path: one conv_step of a hand-built stride-2 'sparse_pallas'
    ConvSpec at conv2's shapes (K4 counted once), its state within 1e-5
    and its mask equal to the same spec in 'dense' mode;
11. card against CPU: 8 chunks of the incremental path on the card and on
    the CPU (the kernels' plain versions): grids within 1e-4;
12. profile: the synchronizing CUDA calls of one sequential chunk (sync
    debug mode) against the layers' counted flag reads, then one chunk
    under torch.profiler.

It then prints the kernels' JSON line, the nvidia-smi line, and last the
result line.  K1's and K2's ``ms`` are CUDA-event times over many calls;
K3's and K4's ``ms`` are their kernels' device time per call from
torch.profiler (``call_ms`` beside it is the event-timed wall time of a
wrapper call, which the host's launch overhead sets at these sizes), and
``dense_pair_ms`` the device time of the dense conv pair.  K3's times and
bound are the sums over its seven layer calls of one chunk.  Any failure raises and exits non-zero without a result line;
without a CUDA device, or without the package beside it, it exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
H, W = 160, 224
T_CHUNKS = 200
CAPACITY = 256
LEAK = 5e-5
# H100 SXM: device memory 3.35 TB/s, float32 outside the tensor cores
# 67 TFLOP/s (NVIDIA data sheet); the bounds below are against these
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
DISPATCHES = 16
OUT_TOL = 1e-4
SEQ_CHUNKS = 64
WARM_CHUNKS = 8
CAPACITY_FRAC = 0.25
KERNEL_REL_TOL = 1e-5


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def synth_stream(rng, steps, events_per_step, h=H, w=W, rate_us=15):
    """Uniform random events, ts gaps in [1, rate_us) µs (the shape of the
    JAX benchmark's synthetic stream)."""
    n = steps * events_per_step
    ts = np.cumsum(rng.randint(1, rate_us, size=n)).astype(np.int32)
    y = rng.randint(0, h, size=n).astype(np.int32)
    x = rng.randint(0, w, size=n).astype(np.int32)
    return np.stack([y, x, ts], axis=-1)


def clustered_stream(rng, steps, events_per_step, radius=8, rate_us=15, h=H, w=W):
    """Events around a drifting centre, ts gaps in [1, rate_us) µs (the JAX
    benchmark's clustered_stream: the spatial statistics of real DVS
    streams)."""
    n = steps * events_per_step
    ts = np.cumsum(rng.randint(1, rate_us, size=n)).astype(np.int32)
    t = np.arange(n) / events_per_step
    cy = h / 2 + h / 3 * np.sin(t * 0.05)
    cx = w / 2 + w / 3 * np.cos(t * 0.04)
    y = np.clip(np.round(cy + rng.randn(n) * radius), 0, h - 1).astype(np.int32)
    x = np.clip(np.round(cx + rng.randn(n) * radius), 0, w - 1).astype(np.int32)
    return np.stack([y, x, ts], axis=-1)


def make_params(layer_defs, rng):
    """Seeded random checkpoint-convention weights (HWIO kernels)."""
    return {
        key: val
        for name, size in layer_defs.items()
        if "conv" in name
        for key, val in (
            (f"w_{name}", rng.randn(*size[:2], size[2], size[3]).astype(np.float32) * 0.05),
            (f"b_{name}", rng.randn(size[3]).astype(np.float32) * 0.05),
        )
    }


def bit_equal(a, b) -> bool:
    """Equal bit for bit (so -0.0 and +0.0 differ)."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def time_ms(fn, iters: int, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` calls, by CUDA
    events after a synchronize (warmed up first)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def device_ms(fn, kernel_key=None, iters: int = 20) -> float:
    """Device time per call of ``fn`` under torch.profiler: the kernels
    whose name holds ``kernel_key`` (every kernel when None), summed over
    ``iters`` calls.  Unlike :func:`time_ms` it leaves out the host's time
    between launches, which sets a small kernel's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and (kernel_key is None or kernel_key in e.key)]
    if kernel_key is not None:
        n = sum(e.count for e in hits)
        require(n == iters, f"profiled {n} launches of {kernel_key}, expected {iters}")
    return sum(e.self_device_time_total for e in hits) / iters / 1e3


def bound_ms(n_bytes: int, n_ops: int) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def sequential_surfaces(s0, prev_ts, chunks, leak):
    """Iterated integrate_step: the definition both kernels must equal."""
    from async_ev_cnn_torch.ops.integrate import integrate_step

    outs, s, pts = [], s0, prev_ts
    for i in range(chunks.y.shape[0]):
        if s.shape[0] == 1:
            s2, pts, _, _ = integrate_step(s[0], pts, chunks.y[i], chunks.x[i],
                                           chunks.ts[i], chunks.valid[i], leak)
            s = s2[None]
        else:
            s, pts, _, _ = integrate_step(s, pts, chunks.y[i], chunks.x[i],
                                          chunks.ts[i], chunks.valid[i], leak,
                                          p=chunks.p[i])
        outs.append(s)
    return torch.stack(outs)


def check_kernels_small(dev) -> None:
    """Ragged 2-channel and large-dt cases: kernels == plain == sequential."""
    from async_ev_cnn_torch.layers.types import EventChunk
    from async_ev_cnn_torch.ops import integrate as it
    from async_ev_cnn_torch.ops import surface_scan as sc

    rng = np.random.RandomState(7)
    cases = []
    for channels, (h, w) in ((2, (13, 17)), (1, (16, 16)), (2, (16, 16))):
        t, e = 10, 12
        ts = np.cumsum(rng.randint(1, 40, t * e)).astype(np.int32).reshape(t, e)
        valid = rng.rand(t, e) < 0.8
        valid[3] = False  # one all-padding chunk: an exact identity step
        arrays = (rng.randint(0, h, (t, e)), rng.randint(0, w, (t, e)), ts,
                  rng.randint(0, 2, (t, e)))
        chunks = EventChunk(*(torch.from_numpy(a.astype(np.int32)).to(dev)
                              for a in arrays), torch.from_numpy(valid).to(dev))
        cases.append((channels, h, w, chunks, 3e-3, 5))
    # dt spanning the int32 range: the int->float conversion must round
    # as the plain version's does
    spread = np.array([0, 255, 2**24 + 5, 2**31 - 20], np.int64)
    ts = (np.array([0, 7, 13], np.int64)[:, None] + spread[None, :]).astype(np.int32)
    chunks = EventChunk(*(torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
        rng.randint(0, 8, (3, 4)), rng.randint(0, 8, (3, 4)), ts,
        np.zeros((3, 4)))), torch.ones((3, 4), dtype=torch.bool, device=dev))
    cases.append((1, 8, 8, chunks, 1e-9, 0))

    for channels, h, w, chunks, leak, prev_ts in cases:
        s0 = torch.from_numpy(
            (np.round(rng.rand(channels, h, w) * 2**20) / 2**20).astype(np.float32)).to(dev)
        prev = torch.tensor(prev_ts, dtype=torch.int32, device=dev)
        ref = sequential_surfaces(s0, prev, chunks, leak)
        pix, dt, d, _ = it.chunk_event_updates(channels, h, w, prev, chunks, leak)
        ts_map, d2, lt = it.chunk_ts_maps(channels, h, w, prev, chunks, leak)
        k1 = sc.surface_scan_events(s0, pix, dt, d, leak)
        k2 = sc.surface_scan_tsmap(s0, ts_map, d2, lt, leak)
        torch.cuda.synchronize()
        what = f"C={channels} {h}x{w} leak={leak}"
        require(bit_equal(k1, sc.surface_scan_events_plain(s0, pix, dt, d, leak)),
                f"K1 != plain ({what})")
        require(bit_equal(k2, sc.surface_scan_tsmap_plain(s0, ts_map, d2, lt, leak)),
                f"K2 != plain ({what})")
        require(bit_equal(k1, ref), f"K1 != iterated integrate_step ({what})")
        require(bit_equal(k2, ref), f"K2 != iterated integrate_step ({what})")

    # zero chunks: an empty result, and no launch is made or counted
    before = dict(sc.LAUNCHES)
    s0 = torch.zeros((1, 8, 8), dtype=torch.float32, device=dev)
    e0 = torch.zeros((0, 4), dtype=torch.int32, device=dev)
    z = torch.zeros(0, dtype=torch.float32, device=dev)
    require(sc.surface_scan_events(s0, e0, e0, z, 1e-3).shape == (0, 1, 8, 8)
            and sc.surface_scan_tsmap(s0, e0.reshape(0, 1, 8, 8), z, e0[:, 0], 1e-3
                                      ).shape == (0, 1, 8, 8)
            and sc.LAUNCHES == before, "zero-chunk calls launched or counted")



def hwc_padded(spec, plane):
    """A layer's input plane, zero-padded by its conv pads, as HWC."""
    import torch.nn.functional as F

    (pt, pb), (pl, pr) = spec.pads
    return F.pad(plane.float(), (pl, pr, pt, pb)).permute(1, 2, 0).contiguous()


def box_pixels(rows, cols, hp, wp, kh, box_w, stride=1) -> int:
    """Distinct padded-plane pixels that the boxes at (rows * stride, cols)
    of kh x box_w cover: what a gather must read at least once."""
    seen = np.zeros((hp, wp), bool)
    for y, x in zip(rows, cols):
        seen[y * stride:y * stride + kh, x:x + box_w] = True
    return int(seen.sum())


def rulebook_case(name, spec, kernel, bias, prev_io, dev):
    """One rulebook kernel call at a layer's shapes, from its real active
    mask: the kernel against its plain version, the times and the bound."""
    from async_ev_cnn_torch.ops import conv as tconv
    from async_ev_cnn_torch.ops import masks as tmasks
    from async_ev_cnn_torch.ops import rulebook_gemm as rg

    active = tmasks.dilate_mask(prev_io.mask, spec.ksize, spec.stride, spec.pads)
    fm, ca = hwc_padded(spec, prev_io.featuremap), hwc_padded(spec, prev_io.conv_actfn)
    w_hwio = kernel.permute(2, 3, 1, 0).contiguous().float()
    bias = bias.float().contiguous()
    hp, wp, c = fm.shape
    kh, kw = spec.ksize
    o = kernel.shape[0]
    if spec.stride == 1:
        # where the mask overflows the capacity (the path then falls back
        # to 'dense'), the kernel still runs here on the first blocks
        by, bx, valid, n_active = tmasks.mask_to_block_coords(
            active, spec.block_capacity, rg.BLOCK_W)
        args = (fm, ca, w_hwio, bias, by, bx)
        kernel_fn, plain_fn, kwargs = (rg.rulebook_gather_gemm_blocks,
                                       rg.rulebook_gather_gemm_blocks_plain, {})
        sites_per_box, box_w = rg.BLOCK_W, rg.BLOCK_W + kw - 1
        cols_scale = rg.BLOCK_W
    else:
        ys, xs, valid = tmasks.mask_to_topk_coords(active, spec.capacity)
        n_active = active.sum()
        args = (fm, ca, w_hwio, bias, ys, xs)
        kernel_fn, plain_fn = rg.rulebook_gather_gemm, rg.rulebook_gather_gemm_plain
        kwargs = {"stride": spec.stride}
        sites_per_box, box_w, cols_scale = 1, kw, spec.stride
    got = kernel_fn(*args, **kwargs)
    want = plain_fn(*args, **kwargs)
    torch.cuda.synchronize()
    err = max(float((g - w_).abs().max()) for g, w_ in zip(got, want))
    tol = KERNEL_REL_TOL * (1 + max(float(w_.abs().max()) for w_ in want))
    require(err <= tol, f"{name}: {kernel_fn.__name__} differs from its plain version "
            f"by {err} > {tol}")
    # the work this mask needs: the valid boxes' distinct input pixels of
    # both planes, the weights and bias, the coordinates, and the valid
    # boxes' outputs of both planes; 2 flops (one FFMA) per term
    keep = valid.cpu().numpy()
    rows = args[4].cpu().numpy()[keep]
    cols = args[5].cpu().numpy()[keep] * cols_scale
    n_valid = int(keep.sum())
    pixels = box_pixels(rows, cols, hp, wp, kh, box_w, spec.stride)
    n_bytes = 4 * (2 * pixels * c + kh * kw * c * o + o + 2 * args[4].numel()
                   + 2 * n_valid * sites_per_box * o)
    n_ops = 2 * 2 * n_valid * sites_per_box * kh * kw * c * o
    pair = torch.stack([prev_io.featuremap, prev_io.conv_actfn]).float()
    return {
        "layer": name, "k": int(args[4].numel()), "valid": n_valid,
        "active": int(n_active), "c": c, "o": o,
        "err": err,
        "ms": device_ms(lambda: kernel_fn(*args, **kwargs), "rulebook_kernel"),
        "call_ms": time_ms(lambda: kernel_fn(*args, **kwargs), 50),
        "plain_ms": time_ms(lambda: plain_fn(*args, **kwargs), 5),
        "dense_pair_ms": device_ms(lambda: tconv.conv2d_dense(
            pair, kernel, None, spec.stride, spec.padding)),
        "bound": bound_ms(n_bytes, n_ops),
    }


def incremental_phases(dev, args, layer_defs, num_classes, num_bbox, smi):
    """Phases 7-12: the incremental engine at full width.  Returns the K3
    and K4 entries of the kernels' JSON line."""
    from async_ev_cnn_torch.layers import conv2d as tconv2d
    from async_ev_cnn_torch.layers.types import EventChunk
    from async_ev_cnn_torch.models.yolo import YoloEventTorch
    from async_ev_cnn_torch.ops import rulebook_gemm as rg
    from async_ev_cnn_torch.ops import surface_scan as sc
    from async_ev_cnn_torch.utils.equivalence import make_stream, run_equivalence
    from async_ev_cnn_torch.utils.runner import pack_chunks

    def model(mode, where=dev):
        m = YoloEventTorch(
            args.frame_h, args.frame_w, num_classes, layer_defs, args.yolo_cnn_padding,
            args.yolo_num_cells_h, args.yolo_num_cells_w, num_bbox, alpha=0.1,
            leak=args.leak, conv_mode=mode, capacity_frac=CAPACITY_FRAC, device=where)
        m.set_weights(make_params(layer_defs, np.random.RandomState(0)))
        return m

    def part(chunks, a, b):
        return EventChunk(*(f[a:b] for f in chunks))

    sp, dn = model("sparse_pallas"), model("dense")
    net, params = sp.net, sp.params
    require(not net.is_all_full, "the incremental model is all 'full'")
    stream = clustered_stream(np.random.RandomState(3), WARM_CHUNKS + SEQ_CHUNKS, CAPACITY)
    chunks = pack_chunks(stream, CAPACITY, device=dev)
    warm, run = part(chunks, 0, WARM_CHUNKS), part(chunks, WARM_CHUNKS, None)

    # ---- 7. rulebook kernels at every conv layer's shapes -------------------
    state = sp.init_state()
    for i in range(WARM_CHUNKS):
        state, ios = net.forward(params, state, EventChunk(*(f[i] for f in warm)))
    layers = net.event_layers
    k3 = [rulebook_case(ld.name, ld.spec, params[f"w_{ld.name}"], params[f"b_{ld.name}"],
                        ios[layers[j - 1].name], dev)
          for j, ld in enumerate(layers) if ld.kind == "conv"]
    conv2 = next(ld for ld in layers if ld.name == "conv2")
    k4_spec = conv2.spec._replace(stride=2, mode="sparse_pallas")
    pool1_io = ios["pool1"]
    k4 = rulebook_case("conv2/stride2", k4_spec, params["w_conv2"], params["b_conv2"],
                       pool1_io, dev)
    print("rulebook-kernels: K3 == plain and K4 == plain within "
          f"{KERNEL_REL_TOL} * (1 + max|plain|) at chunk {WARM_CHUNKS} of the clustered "
          "stream; " + "; ".join(
              f"{r['layer']} K={r['k']} ({r['valid']} valid of {r['active']} active) "
              f"C={r['c']} O={r['o']}: "
              f"device {r['ms']:.4f} ms (a call {r['call_ms']:.4f}, plain "
              f"{r['plain_ms']:.3f}, dense pair device {r['dense_pair_ms']:.4f}, bound "
              f"{r['bound'][0]:.5f} {r['bound'][1]}), "
              f"err {r['err']:.2e}" for r in k3 + [k4]), flush=True)

    # ---- 8. the incremental path ----------------------------------------------
    sp.scan(sp.init_state(), part(warm, 0, 4))  # warm-up: allocator, cuDNN set-up
    dn.scan(dn.init_state(), part(warm, 0, 4))
    st_sp, st_dn = sp.init_state(), dn.init_state()
    # the main path: the counts are set to 0 just before it, read just after
    rg.reset_launches()
    sc.reset_launches()
    net.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_sp, grids_sp = sp.scan(st_sp, run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    seq_launches = dict(rg.LAUNCHES)
    per_layer = {k: dict(v) for k, v in net.layer_counts.items()}
    require(dict(sc.LAUNCHES) == {"surface_scan_events": 0, "surface_scan_tsmap": 0},
            f"the sequential path launched a surface scan: {sc.LAUNCHES}")
    require(per_layer["conv1"].get("kernel_launches", 0) == SEQ_CHUNKS,
            f"K3 launched {per_layer['conv1'].get('kernel_launches', 0)} times at conv1 "
            f"over {SEQ_CHUNKS} chunks")
    require(seq_launches["rulebook_gather_gemm_blocks"]
            == sum(v.get("kernel_launches", 0) for v in per_layer.values())
            and seq_launches["rulebook_gather_gemm"] == 0,
            f"launch counts {seq_launches} disagree with the layers' {per_layer}")
    t0 = time.perf_counter()
    st_dn, grids_dn = dn.scan(st_dn, run)
    torch.cuda.synchronize()
    wall_dn = time.perf_counter() - t0
    require(tuple(grids_sp.shape) == (SEQ_CHUNKS, *sp.grid_shape)
            and bool(torch.isfinite(grids_sp).all()), "sequential grids' shape or values")
    seq_err = float((grids_sp - grids_dn).abs().max())
    require(seq_err <= OUT_TOL, f"'sparse_pallas' grids differ from 'dense' by {seq_err}")
    n_events = int(run.valid.sum())
    print(f"sequential-path: YoloEventTorch.scan (conv_mode='sparse_pallas', capacity "
          f"{CAPACITY_FRAC}) over {SEQ_CHUNKS} clustered chunks of {CAPACITY} events: "
          f"{n_events / wall:.0f} events/s, {wall * 1e3 / SEQ_CHUNKS:.3f} ms/chunk "
          f"(conv_mode='dense': {n_events / wall_dn:.0f} events/s, "
          f"{wall_dn * 1e3 / SEQ_CHUNKS:.3f} ms/chunk); grids within {seq_err:.2e} of "
          f"'dense'; launches {seq_launches}; per layer (K3 launches, dense fallbacks, "
          "host reads): " + ", ".join(
              f"{k} ({v.get('kernel_launches', 0)}, {v.get('dense_fallbacks', 0)}, "
              f"{v.get('host_syncs', 0)})" for k, v in per_layer.items())
          + f"; card {smi!r}", flush=True)

    # ---- 9. the async == dense gate at full width ------------------------------
    gate = {}
    for m in (sp, dn):
        gchunks = make_stream(np.random.RandomState(0), 30, 200, H, W, max_dt=30, device=dev)
        rep = run_equivalence(m.net, m.params, gchunks, device=dev)
        worst = max(rep.max_diff.values())
        require(worst <= OUT_TOL, f"{m.net.event_layers[1].spec.mode}: async != dense: "
                f"{dict(rep.max_diff)}")
        gate[m.net.event_layers[1].spec.mode] = worst
    print("gate: run_equivalence at 160x224 (30 steps x 200 uniform events, max_dt 30): "
          "every layer within 1e-4 of the dense oracle; max |async - dense| "
          + ", ".join(f"{k} {v:.3e}" for k, v in gate.items()), flush=True)

    # ---- 10. K4's path: one stride-2 conv_step ---------------------------------
    dense_spec = k4_spec._replace(mode="dense")
    w2, b2 = params["w_conv2"], params["b_conv2"]
    st0, _ = tconv2d.conv_init(k4_spec, w2, b2, pool1_io)
    leak = torch.tensor(3e-4, dtype=torch.float32, device=dev)
    rg.reset_launches()
    st_k, io_k = tconv2d.conv_step(k4_spec, w2, b2, st0, pool1_io, leak)
    torch.cuda.synchronize()
    k4_launches = dict(rg.LAUNCHES)
    st_d, io_d = tconv2d.conv_step(dense_spec, w2, b2, st0, pool1_io, leak)
    require(k4_launches == {"rulebook_gather_gemm_blocks": 0, "rulebook_gather_gemm": 1},
            f"K4's path launches {k4_launches}")
    k4_err = max(float((a - b).abs().max()) for a, b in zip(st_k, st_d))
    require(k4_err <= KERNEL_REL_TOL and torch.equal(io_k.mask, io_d.mask),
            f"stride-2 'sparse_pallas' conv_step differs from 'dense' by {k4_err}")
    print(f"k4-path: conv_step of a stride-2 'sparse_pallas' ConvSpec at conv2's shapes "
          f"{k4_spec.in_shape} -> {k4_spec.out_shape}: state within {k4_err:.2e} of "
          f"'dense', masks equal; launches {k4_launches}", flush=True)

    # ---- 11. card against CPU ------------------------------------------------------
    cpu = model("sparse_pallas", torch.device("cpu"))
    few = part(run, 0, 8)
    _, g_card = sp.scan(sp.init_state(), few)
    _, g_cpu = cpu.scan(cpu.init_state(), EventChunk(*(f.cpu() for f in few)))
    cpu_err = float((g_card.cpu() - g_cpu).abs().max())
    require(cpu_err <= OUT_TOL, f"card and CPU sequential grids differ by {cpu_err}")
    print(f"seq-card-vs-cpu: 8 chunks of the 'sparse_pallas' path on the card and on the "
          f"CPU (plain versions): grids max abs diff {cpu_err:.3e} (tolerance {OUT_TOL})",
          flush=True)

    # ---- 12. where one sequential chunk's time goes ---------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    one = EventChunk(*(f[0] for f in part(run, 0, 1)))
    # every synchronizing CUDA call of one chunk, by the sync debug mode,
    # against the flag reads the layers count
    import warnings

    net.reset_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sp.step(st_sp, one)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    n_syncs = sum("synchroniz" in str(w.message) for w in caught)
    n_reads = sum(v.get("host_syncs", 0) for v in net.layer_counts.values())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sp.step(st_sp, one)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    parts = [(e.key, e.count, e.self_device_time_total) for e in events
             if e.device_type == DeviceType.CPU]
    parts += [(e.key, e.count, e.self_device_time_total) for e in kernels
              if "rulebook_kernel" in e.key]
    top = sorted(parts, key=lambda e: -e[2])[:10]
    print(f"seq-syncs: one sequential chunk makes {n_syncs} synchronizing CUDA calls "
          f"(torch.cuda sync debug mode); the conv layers count {n_reads} flag reads",
          flush=True)
    print(f"seq-profile: one sequential chunk under torch.profiler: wall {wall_ms:.2f} ms, "
          f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% of wall); device "
          "time by op: " + "; ".join(f"{k[:60]} x{n} {us / 1e3:.3f} ms" for k, n, us in top),
          flush=True)

    def total(key):
        return sum(r[key] for r in k3)

    k3_bytes_ms = sum(r["bound"][0] for r in k3 if r["bound"][1] == "bytes")
    k3_ops_ms = sum(r["bound"][0] for r in k3 if r["bound"][1] == "operations")
    src = "async_ev_cnn_torch/csrc/rulebook.cu"
    return [
        {"name": "rulebook_gather_gemm_blocks", "route": "cuda", "source": src,
         "replaces": "async_ev_cnn_tpu/ops/pallas_rulebook_blocks.py:94",
         "launches": seq_launches["rulebook_gather_gemm_blocks"],
         "max_abs_err": max(r["err"] for r in k3), "ms": total("ms"),
         "plain_ms": total("plain_ms"), "bound_ms": k3_bytes_ms + k3_ops_ms,
         "bound_by": "bytes" if k3_bytes_ms >= k3_ops_ms else "operations",
         # no single PyTorch call gathers and multiplies at the active sites
         "library_ms": None, "dense_pair_ms": total("dense_pair_ms"),
         "call_ms": total("call_ms")},
        {"name": "rulebook_gather_gemm", "route": "cuda", "source": src,
         "replaces": "async_ev_cnn_tpu/ops/pallas_rulebook.py:97",
         "launches": k4_launches["rulebook_gather_gemm"], "max_abs_err": k4["err"],
         "ms": k4["ms"], "plain_ms": k4["plain_ms"], "bound_ms": k4["bound"][0],
         "bound_by": k4["bound"][1], "library_ms": None,
         "dense_pair_ms": k4["dense_pair_ms"], "call_ms": k4["call_ms"]},
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import async_ev_cnn_torch

    pkg_root = Path(async_ev_cnn_torch.__file__).resolve().parent.parent
    require(pkg_root == HERE,
            f"async_ev_cnn_torch imported from {pkg_root}, not from this checkout")

    from async_ev_cnn_torch.models import head
    from async_ev_cnn_torch.models.yolo import YoloEventTorch
    from async_ev_cnn_torch.ops import cuda_build
    from async_ev_cnn_torch.ops import integrate as it
    from async_ev_cnn_torch.ops import surface_scan as sc
    from async_ev_cnn_torch.ops.conv import set_matmul_precision
    from async_ev_cnn_torch.utils.config import config
    from async_ev_cnn_torch.utils.runner import pack_chunks
    from async_ev_cnn_torch.utils.serving import StreamingPipeline

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 1. environment ----------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    set_matmul_precision("highest")
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    require(tf32 == (False, False), f"TF32 still on after 'highest': {tf32}")
    print(f"env: device={name!r} count={torch.cuda.device_count()} "
          f"nvidia-smi={smi!r} torch={torch.__version__} cuda={torch.version.cuda} "
          f"python={sys.version.split()[0]} tf32(cudnn, cublas)={tf32}", flush=True)

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    sources = ("surface_scan", "rulebook")
    cuda_build.load_all(sources)  # one nvcc per source, started together
    parts = []
    for src in sources:
        built = cuda_build.BUILD_SECONDS.get(src)
        ptxas = " | ".join(line.strip() for line in cuda_build.build_log(src).splitlines()
                           if "Used" in line or "spill" in line)
        parts.append(f"{src}.cu (nvcc "
                     f"{'%.2f s' % built if built is not None else 'skipped: already built'}"
                     f"; ptxas: {ptxas})")
    print(f"build: loaded in {time.perf_counter() - t0:.2f} s: " + "; ".join(parts),
          flush=True)

    # ---- 3. kernels against their plain versions ----------------------------
    rng = np.random.RandomState(0)
    chunks = pack_chunks(synth_stream(rng, T_CHUNKS, CAPACITY), CAPACITY, device=dev)
    s0 = torch.from_numpy(
        (np.round(rng.rand(1, H, W) * 2**20) / 2**20).astype(np.float32)).to(dev)
    prev = torch.tensor(0, dtype=torch.int32, device=dev)
    pix, dt, d, last_ts = it.chunk_event_updates(1, H, W, prev, chunks, LEAK)
    ts_map, d2, lt2 = it.chunk_ts_maps(1, H, W, prev, chunks, LEAK)
    require(torch.equal(d, d2) and torch.equal(last_ts, lt2), "the two fronts' scalar chains differ")
    k1 = sc.surface_scan_events(s0, pix, dt, d, LEAK)
    k2 = sc.surface_scan_tsmap(s0, ts_map, d2, lt2, LEAK)
    p1 = sc.surface_scan_events_plain(s0, pix, dt, d, LEAK)
    p2 = sc.surface_scan_tsmap_plain(s0, ts_map, d2, lt2, LEAK)
    torch.cuda.synchronize()
    require(bit_equal(k1, p1), "K1 (surface_scan_events) != its plain version at full width")
    require(bit_equal(k2, p2), "K2 (surface_scan_tsmap) != its plain version at full width")
    require(bit_equal(k1, k2), "K1 != K2 at full width")
    check_kernels_small(dev)
    err1 = float((k1 - p1).abs().max())
    err2 = float((k2 - p2).abs().max())

    t_len, e_len = pix.shape
    p_len = H * W
    timings = {
        "surface_scan_events": (
            time_ms(lambda: sc.surface_scan_events(s0, pix, dt, d, LEAK), 50),
            time_ms(lambda: sc.surface_scan_events_plain(s0, pix, dt, d, LEAK), 3),
            # surfaces written, surface + winner lists + decrements read
            bound_ms(4 * (t_len * p_len + p_len + 2 * t_len * e_len + t_len),
                     4 * t_len * p_len + 6 * t_len * e_len),
            err1,
        ),
        "surface_scan_tsmap": (
            time_ms(lambda: sc.surface_scan_tsmap(s0, ts_map, d2, lt2, LEAK), 50),
            time_ms(lambda: sc.surface_scan_tsmap_plain(s0, ts_map, d2, lt2, LEAK), 3),
            # ts maps read and surfaces written, surface + scalars read
            bound_ms(4 * (2 * t_len * p_len + p_len + 2 * t_len),
                     10 * t_len * p_len),
            err2,
        ),
    }
    print("kernels: K1 == plain, K2 == plain, K1 == K2 bit for bit at "
          f"C=1 {H}x{W} T={t_len} E={e_len}; ragged 2-channel, large-dt and "
          "iterated-integrate_step cases bit-equal; "
          + "; ".join(f"{k} {v[0]:.4f} ms (plain {v[1]:.3f} ms, bound {v[2][0]:.4f} ms)"
                      for k, v in timings.items()), flush=True)
    del k1, k2, p1, p2, ts_map

    # ---- 4. the main path ------------------------------------------------------
    args = config(["-c", str(HERE / "configs" / "efcn_event.yml")])
    layer_defs = args.yolo_cnn_layers
    num_bbox = args.yolo_num_bbox
    out_c = list(layer_defs.values())[-1][3]
    num_classes = out_c - num_bbox * 5
    model = YoloEventTorch(
        args.frame_h, args.frame_w, num_classes, layer_defs, args.yolo_cnn_padding,
        args.yolo_num_cells_h, args.yolo_num_cells_w, num_bbox, alpha=0.1,
        leak=args.leak, conv_mode="full", device=dev,
    )
    require((args.frame_h, args.frame_w, args.leak) == (H, W, LEAK), "efcn config changed")
    model.set_weights(make_params(layer_defs, np.random.RandomState(0)))
    grid = model.grid_shape

    def post(outs):
        boxes, _, probs = head.decode(outs.reshape(-1, *grid), num_classes, num_bbox,
                                      args.frame_h, args.frame_w)
        return boxes, probs

    pipe = StreamingPipeline(model.net, model.params, capacity=CAPACITY,
                             t_chunks=T_CHUNKS, wire="plain", postprocess=post,
                             max_in_flight=2, device=dev)
    # one item more than the counted run serves: the profiled dispatch
    stream = synth_stream(np.random.RandomState(1), (DISPATCHES + 1) * T_CHUNKS, CAPACITY)
    items = np.split(stream, DISPATCHES + 1)

    # the main path: the counts are set to 0 just before it, read just after
    sc.reset_launches()
    torch.cuda.synchronize()
    warm = list(pipe.serve(items[:1]))  # first dispatch: cuDNN set-up
    t0 = time.perf_counter()
    rest = list(pipe.serve(items[1:DISPATCHES]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_launches = dict(sc.LAUNCHES)
    served = warm + rest

    require(len(served) == DISPATCHES, f"served {len(served)} of {DISPATCHES} dispatches")
    # T=200 chunks is one window: K1 once per dispatch, K2 never
    require(main_launches == {"surface_scan_events": DISPATCHES, "surface_scan_tsmap": 0},
            f"main path launches {main_launches} for {DISPATCHES} single-window dispatches")
    for r in served:
        boxes, probs = r.outputs
        require(boxes.shape == (T_CHUNKS, grid[0] * grid[1] * num_bbox, 4)
                and probs.shape == (T_CHUNKS, grid[0] * grid[1] * num_bbox, num_classes),
                f"decoded shapes {tuple(boxes.shape)}, {tuple(probs.shape)}")
        require(bool(torch.isfinite(boxes).all() and torch.isfinite(probs).all()),
                "non-finite outputs")
        require(r.n_events == T_CHUNKS * CAPACITY, f"dispatch consumed {r.n_events} events")
    # the pipeline's first dispatch against scan_parallel from the initial state
    st0 = model.init_state()
    c0 = pack_chunks(items[0], CAPACITY, device=dev)
    st_e, out_e = model.net.scan_parallel(model.params, st0, c0)
    boxes0, probs0 = post(out_e)
    require(float((boxes0 - served[0].outputs[0]).abs().max()) <= OUT_TOL
            and float((probs0 - served[0].outputs[1]).abs().max()) <= OUT_TOL,
            "pipeline's first dispatch differs from scan_parallel")
    lat = pipe.latency_stats()
    n_events = sum(r.n_events for r in rest)
    print(f"path: eFCN {H}x{W} conv1..conv7, {DISPATCHES} dispatches of {T_CHUNKS} x "
          f"{CAPACITY} events through StreamingPipeline(wire='plain', max_in_flight=2): "
          f"{n_events / wall:.0f} events/s over dispatches 2..{DISPATCHES} "
          f"({wall * 1e3 / (DISPATCHES - 1):.2f} ms/dispatch), dispatch latency "
          f"p50 {lat['dispatch_latency_ms']['p50']} ms over all {lat['n']}; "
          f"launches {main_launches} "
          f"({main_launches['surface_scan_events'] / DISPATCHES:g} K1 per dispatch); "
          f"card {smi!r}", flush=True)

    # the ts-map engine's path: one full-width dispatch through K2, its
    # counts set to 0 just before it and read just after
    sc.reset_launches()
    st_t, out_t = model.net.scan_parallel(model.params, st0, c0, integrate_engine="tsmap")
    torch.cuda.synchronize()
    tsmap_launches = dict(sc.LAUNCHES)
    require(tsmap_launches == {"surface_scan_events": 0, "surface_scan_tsmap": 1},
            f"ts-map path launches {tsmap_launches} for one single-window dispatch")
    require(bit_equal(st_t[0].surface, st_e[0].surface)
            and float((out_t - out_e).abs().max()) <= OUT_TOL,
            "ts-map engine's dispatch differs from the default engine's")
    print(f"tsmap-path: one {T_CHUNKS}-chunk dispatch through EventNetwork.scan_parallel("
          f"integrate_engine='tsmap'): surface bit-equal and outputs within {OUT_TOL} of "
          f"the default engine's; launches {tsmap_launches}", flush=True)

    # ---- 5. card against CPU -------------------------------------------------
    t_small = 16
    item = synth_stream(np.random.RandomState(2), t_small, CAPACITY)
    runs = []
    for where in (dev, torch.device("cpu")):
        params = {k: v.to(where) for k, v in model.params.items()}
        p = StreamingPipeline(model.net, params, capacity=CAPACITY, t_chunks=t_small,
                              wire="plain", device=where)
        (r,) = p.serve([item])
        runs.append((r.outputs.cpu(), p.state[0].surface.cpu(), int(p.state[0].prev_ts)))
    (o_g, s_g, ts_g), (o_c, s_c, ts_c) = runs
    require(bit_equal(s_g, s_c) and ts_g == ts_c, "card and CPU surfaces differ")
    out_err = float((o_g - o_c).abs().max())
    require(out_err <= OUT_TOL, f"card and CPU outputs differ by {out_err}")
    print(f"card-vs-cpu: T={t_small}: surfaces bit-equal, prev_ts {ts_g} == {ts_c}, "
          f"grid outputs max abs diff {out_err:.3e} (tolerance {OUT_TOL})", flush=True)

    # ---- 6. where one dispatch's time goes -----------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        list(pipe.serve(items[DISPATCHES:]))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    # device time is counted once on the kernels; the ops that launched
    # them give the readable breakdown (our ctypes launches have no op)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    parts = [(e.key, e.count, e.self_device_time_total) for e in events
             if e.device_type == DeviceType.CPU]
    parts += [(e.key, e.count, e.self_device_time_total) for e in kernels
              if "scan_events_kernel" in e.key or "scan_tsmap_kernel" in e.key]
    top = sorted(parts, key=lambda e: -e[2])[:10]
    print(f"profile: one T={T_CHUNKS} dispatch under torch.profiler: wall {wall_ms:.2f} ms, "
          f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% of wall); device "
          "time by op: " + "; ".join(f"{k[:60]} x{n} {us / 1e3:.3f} ms" for k, n, us in top),
          flush=True)

    rulebook_kernels = incremental_phases(dev, args, layer_defs, num_classes, num_bbox, smi)

    sources = {"surface_scan_events": "async_ev_cnn_tpu/ops/pallas_scan.py:273",
               "surface_scan_tsmap": "async_ev_cnn_tpu/ops/pallas_scan.py:105"}
    # each kernel's launches come from the run of its own path
    launches = {"surface_scan_events": main_launches["surface_scan_events"],
                "surface_scan_tsmap": tsmap_launches["surface_scan_tsmap"]}
    kernels = []
    for k, (ms, plain_ms, (b_ms, b_by), err) in timings.items():
        kernels.append({
            "name": k, "route": "cuda", "source": "async_ev_cnn_torch/csrc/surface_scan.cu",
            "replaces": sources[k], "launches": launches[k], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            # no single PyTorch call computes the T-step clamped recurrence
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels + rulebook_kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
