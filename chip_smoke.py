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

It then prints the kernels' JSON line, the nvidia-smi line, and last the
result line.  Any failure raises and exits non-zero without a result line;
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
    cuda_build.load("surface_scan")
    built = cuda_build.BUILD_SECONDS.get("surface_scan")
    ptxas = " | ".join(line.strip() for line in cuda_build.build_log("surface_scan").splitlines()
                       if "Used" in line or "spill" in line)
    print(f"build: surface_scan.cu loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {'%.2f s' % built if built is not None else 'skipped: already built'}); "
          f"ptxas: {ptxas}", flush=True)

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
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
