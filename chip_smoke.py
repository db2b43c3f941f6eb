#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (async_ev_cnn_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

``python3 chip_smoke.py --compare PARENT`` instead times K2 and K6 (device
time, and K6's SASS count) of the checkout at PARENT against this one's on
one card, in the order parent, this, this, parent.

Phases, one line each on standard output:

1. environment: the card, its power limit, torch/CUDA versions, TF32 off;
2. build: every kernel source of async_ev_cnn_torch/csrc with nvcc, one
   nvcc per source, all started together, with ptxas's registers and
   spills of each, and K6's SASS instructions a pooled pixel and channel
   (cuobjdump);
3. kernels: each kernel against its plain PyTorch version bit for bit at
   the eFCN's full width (160x224, T=200 chunks of 256 events), against
   each other, on the winner lists of a clustered stream (make_stream,
   radius 8), on 2-channel ragged cases (one across two of K1's windows),
   with winners replaced by -1 and by P, on a large-dt case, and against
   iterating integrate_step, and K2 across two of its windows and tiles;
   with K1's device time (its binning pass and scan) on the uniform and
   the clustered lists, the binning pass's share, the device time of the
   winner dedup (chunk_event_updates) beside it, K2's plan and device
   time, and the memory bounds;
4. path: the eFCN from configs/efcn_event.yml with seeded random weights,
   served by StreamingPipeline (plain wire, T=200 chunks per dispatch,
   batched head.decode, the default 'events' engine: K1) for 16
   dispatches; then the ts-map engine's path (K2), one full-width
   EventNetwork.scan_parallel(integrate_engine='tsmap') dispatch.  The
   launch counts are set to 0 just before each path and read just after
   it, and each kernel's count is its own path's;
5. card against CPU: one T=16 dispatch by the same port on the card and on
   the CPU: surfaces bit-equal, grid outputs within 1e-4; then
   maxpool_dense on int32, bool and float32 maps at 'VALID' and 'SAME',
   equal to the same calls on the CPU;
6. profile: one more dispatch under torch.profiler, with the device-busy
   share of its wall time and the kernels that take the most device time.

Then the incremental (sequential) engine, the eFCN in conv_mode
'sparse_pallas' on a clustered stream (events around a drifting centre,
radius 8, ts gaps 1..14 us, the JAX benchmark's clustered_stream):

7. rulebook kernels: first the gather-GEMM that K3, K4 and K5 share
   (csrc/gather_gemm.cu) at its edges (O = 110, C = 1, ow = 7, right-edge
   blocks, uneven reduction splits, planes off 16-byte alignment; K4 also
   at strides 2 and 3 with boxes past the bottom and right edges) at
   'highest' and 'default'; then K3 (rulebook_gather_gemm_blocks) at every
   conv layer's shapes, its 1x8 blocks taken from that layer's real active
   mask at its block capacity, and K4 (rulebook_gather_gemm) at stride 2 on
   conv2's shapes (and once more with 64 output channels, the wide tile's
   full width), each against its plain version within 1e-5 * (1 + max
   |plain|) (float32 sums of up to 9 * 512 terms in another order) at
   'highest' and 'default' and bit for bit against a second launch; with
   the launch plan (tile, splits, grid), device times, the plain versions'
   times, the memory/FFMA bound and the time of the layer's dense
   [2, C, H, W] conv pair (the crossover reference);
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

Then the kernels and paths that the JAX package keeps beside its main
paths, and the precision options:

13. K5 (rows_gather_conv): at every conv layer's shapes, its active rows
    taken from that layer's real mask of the clustered stream at its
    row_capacity, against its plain version within 1e-5 * (1 + max
    |plain|) at 'highest' and 'default' and bit for bit against a second
    launch, with its launch plan, its device time, its split pass's share,
    its device time with the reduction unsplit (S = 1) and with one split
    more than the plan's, the plain version's time, the bound and the
    device time of rows_conv_pair's own conv over the gathered row stack;
    then its path, the 'sparse_rows' update of one chunk through K5
    (kernel_rows_conv_pair) at every layer, within the same tolerance
    of rows_conv_pair (counts set to 0 just before, read just after);
14. K6 (fused_stem) on the T=200 surfaces of a full-width dispatch (its
    path: one call, counted), within K6_TOL * (1 + max |plain|) of its
    plain version and bit-equal across two launches, within 1e-5 of
    fused_conv_pool and of the direct 'full' conv1 -> pool1 at 'highest';
    the same at its edge shapes (K6_EDGES: T = 1, H/2 not a multiple of
    the band, W/2 odd, O = 1 and 64, alpha < 0 and > 1, the library stems
    where alpha <= 1); the device times of all four;
15. K7 (gather_copy): each shape and kh against its plain version at grid
    4, 2 copies, bit for bit; then its path, the slope table of all 12
    (shape, kh) rows (counted): µs a copy, µs a row, GB/s and its share of
    3.35 TB/s; then each row again at the table's grid 16384 x 8 copies
    against its plain version, bit for bit;
16. the stem path: the full-width eFCN scan_parallel at T=200, unfused
    against stem_fusion=True at 'highest': outputs within 1e-5, events/s of
    both, and the fused pair's conv calls;
17. tiers: at 'highest', 'high', 'default' and 'default' with bf16
    activations: the parallel path's events/s under 'auto', fused against
    unfused, the full-width gate (200 steps) in 'full' and 'dense', and at
    'default' the gate in 'sparse_pallas' (recorded, not held to 1e-4);
    'highest' is restored whatever happens.

It then prints the kernels' JSON line, the nvidia-smi line, and last the
result line.  K1's to K6's ``ms`` are their device time per call from
torch.profiler (K1's: the binning pass and the scan; K3's, K4's and K5's:
the gather-GEMM kernel plus, where the plan splits the reduction, its
split pass; K6's: the kernel and the two copies of its taps into constant
memory; ``call_ms`` beside it is the event-timed wall time of a wrapper
call, which the host's launch overhead sets at these sizes), K7's a
CUDA-event time, and ``dense_pair_ms`` the device time of the dense conv
pair.  K3's and K5's
times and bounds are the sums over their seven layer calls of one
chunk.  Any failure raises and exits non-zero without a
result line; without a CUDA device, or without the package beside it, it
exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from functools import partial
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
# the kernels of one K3, K4 or K5 call (csrc/gather_gemm.cu): the
# gather-GEMM and, where its plan splits the reduction, the split pass
GG_KERNELS = ("gather_gemm_kernel", "split_sum_kernel")
# the kernels of one K1 call (csrc/surface_scan.cu): the binning pass, the scan
K1_KERNELS = ("bin_events_kernel", "scan_events_kernel")
# K6's instance on the eFCN (csrc/fused_stem.cu): O = 16, pool then activate
K6_HOT_INSTANCE = "fused_stem_kernelILi16ELb1E"
# the gather-GEMM's edge shapes: (what, hp, wp, C, O, kh, kw, float offset
# of the planes from a 16-byte boundary, stride).  Stride 1 runs K3, K5 and
# K4; another stride runs K4 alone, its sites one past the last output row
# and column (boxes past the bottom and right edges).
GG_EDGES = (
    ("O=110 ow=7", 5, 7, 24, 110, 1, 1, 0, 1),
    ("C=1 O=16 ow=7", 8, 9, 1, 16, 3, 3, 0, 1),
    ("C=1 O=16 wide", 10, 42, 1, 16, 3, 3, 0, 1),
    ("C=3 O=70 ow=7", 7, 9, 3, 70, 3, 3, 0, 1),
    ("uneven splits", 5, 9, 200, 300, 3, 3, 0, 1),
    ("planes off 16 B", 6, 12, 8, 40, 3, 3, 1, 1),
    ("stride 2 C=16 O=32", 13, 17, 16, 32, 3, 3, 0, 2),
    ("stride 3 C=3 O=70", 14, 19, 3, 70, 3, 3, 0, 3),
    ("stride 2 C=1 O=16", 11, 12, 1, 16, 3, 3, 0, 2),
    ("stride 2 O=110", 9, 9, 24, 110, 1, 1, 0, 2),
    ("stride 3 off 16 B", 10, 13, 8, 40, 3, 3, 1, 3),
)
TIER_GATE_STEPS = 200
# K6 against its plain version: |kernel - plain| <= K6_TOL * (1 + max|plain|).
# The kernel rounds each of its 9 taps once (an FMA) where the plain
# version rounds product and sum apart, so a conv value moves by at most
# half an ulp of each product and of each partial sum: 19 half-ulps of the
# largest term of the chain, about 1.1e-6 of it, and far less in practice
# (the roundings are independent); the 2x2 max and the activation add no
# error of their own (monotone for 0 <= alpha <= 1; the same order
# otherwise).
K6_TOL = 1e-6
# K6's edge shapes: (what, T, H, W, O, alpha).  The band is 8 pooled rows
# and a thread takes 2x2 pooled pixels; O = 16 is the unrolled instance,
# every other O the generic one, and alpha outside [0, 1] the
# activate-then-pool one.
K6_EDGES = (
    ("T=1", 1, 160, 224, 16, 0.1),
    ("O=64 full width", 4, 160, 224, 64, 0.1),
    ("H/2=9 W/2=7 O=1", 3, 18, 14, 1, 0.1),
    ("H/2=11 W/2=15 O=64", 2, 22, 30, 64, 0.1),
    ("H/2=10 W/2=13 O=16 alpha<0", 2, 20, 26, 16, -0.2),
    ("H/2=5 W/2=1 O=7 alpha<0", 3, 10, 2, 7, -0.2),
    ("H/2=10 W/2=13 O=16 alpha>1", 2, 20, 26, 16, 1.5),
)


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


def device_ms(fn, kernel_keys=None, iters: int = 20, per_call: int = 1) -> float:
    """Device time per call of ``fn`` under torch.profiler: the kernels
    whose name holds one of ``kernel_keys`` (a name or a tuple of names;
    every kernel when None), summed over ``iters`` calls.  Unlike
    :func:`time_ms` it leaves out the host's time between launches, which
    sets a small kernel's wall time.

    A trace must record exactly ``iters * per_call`` launches of the named
    kernels (``fn`` launches ``per_call`` of them a call), and at least one
    kernel when none is named.  A plain trace has lost kernel records on
    the H100 (once one launch, once a whole trace, once three traces in a
    row; a trace with a profiler schedule loses them often), so a short
    trace is taken again after a pause, 5 traces at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    keys = (kernel_keys,) if isinstance(kernel_keys, str) else kernel_keys
    fn()
    torch.cuda.synchronize()
    counts = []
    for attempt in range(5):
        time.sleep(0.2 * attempt)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                and (keys is None or any(k in e.key for k in keys))]
        total_ms = sum(e.self_device_time_total for e in hits) / 1e3
        counts.append(sum(e.count for e in hits))
        if counts[-1] == iters * per_call or (keys is None and counts[-1] > 0):
            return total_ms / iters
    raise RuntimeError(f"chip_smoke check failed: profiled {counts} launches of "
                       f"{keys} in 5 traces of {iters} calls x {per_call}")


def gg_device_ms(fn, plan) -> float:
    """Device time per call of a K3 or K5 wrapper: its gather-GEMM kernel
    and, where the plan splits the reduction, the split pass."""
    return device_ms(fn, GG_KERNELS, per_call=1 + (plan.splits > 1))


def split_pass_ms(fn, plan) -> float:
    """The split pass's share of :func:`gg_device_ms` (0 without one)."""
    return device_ms(fn, "split_sum_kernel") if plan is not None and plan.splits > 1 else 0.0


def plan_text(plan) -> str:
    return f"{plan.tile} S={plan.splits} grid {'x'.join(map(str, plan.grid))}"


def bound_ms(n_bytes: int, n_ops: int) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def sass_loop_cost(lib_path, kernel_key: str):
    """SASS instructions a pooled pixel and channel in the fused stem's hot
    loop, from ``cuobjdump -sass`` of the library at ``lib_path``: in the
    first kernel whose mangled name holds ``kernel_key``, the smallest loop
    (a backward branch and its target) that holds at least 36 FFMA or FADD,
    its length x 36 / its FFMA + FADD (a pooled pixel and channel is 4 conv
    values of 9 multiply-adds).  Returns (kernel, loop length, FFMA + FADD,
    instructions a pooled pixel and channel), or None without cuobjdump."""
    import re
    from torch.utils.cpp_extension import CUDA_HOME

    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name = chunk.split("\n", 1)[0].strip()
        if kernel_key not in name:
            continue
        instrs, labels, pending = [], {}, []
        for line in chunk.splitlines()[1:]:
            label = re.match(r"\s*(\.L_x_\d+):", line)
            if label:
                pending.append(label.group(1))
                continue
            ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if ins:
                addr = int(ins.group(1), 16)
                labels.update((lab, addr) for lab in pending)
                pending = []
                instrs.append((addr, ins.group(2)))

        def opcode(ins):
            return re.sub(r"^@!?U?P\w+\s+", "", ins).split(" ", 1)[0].split(".")[0]

        loops = []
        for addr, ins in instrs:
            if opcode(ins) != "BRA":
                continue
            target = re.search(r"(\.L_x_\d+)|\b(0x[0-9a-f]+)", ins)
            if target is None:
                continue
            to = labels.get(target.group(1)) if target.group(1) else int(target.group(2), 16)
            if to is None or to > addr:
                continue
            body = [i for a, i in instrs if to <= a <= addr]
            fma = sum(opcode(i) in ("FFMA", "FADD") for i in body)
            if fma >= 36:
                loops.append((len(body), fma))
        if loops:
            n, fma = min(loops)
            return name, n, fma, n * 36 / fma
    return None


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
    """Ragged 2-channel and large-dt cases: kernels == plain == sequential;
    K1 across two windows with winners replaced by -1 and by P."""
    from async_ev_cnn_torch.layers.types import EventChunk
    from async_ev_cnn_torch.ops import integrate as it
    from async_ev_cnn_torch.ops import surface_scan as sc

    rng = np.random.RandomState(7)
    cases = []
    # (13, 17) x 2 channels: 442 pixels, K1's and K2's last tiles ragged; T =
    # 70: two of K1's windows and three of K2's, the last ragged; 7x9, T =
    # 33: two of K2's tiles (the second 31 pixels) and two windows (the
    # second one chunk)
    for channels, (h, w), t in ((2, (13, 17), 10), (1, (16, 16), 10), (2, (16, 16), 10),
                                (2, (13, 17), 70), (1, (7, 9), 33)):
        e = 12
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
        # winners replaced by -1 and by P: no event in either version
        p = channels * h * w
        pix = pix.clone()
        pix[::3, 0] = -1
        pix[1::3, 1] = p
        require(bit_equal(sc.surface_scan_events(s0, pix, dt, d, leak),
                          sc.surface_scan_events_plain(s0, pix, dt, d, leak)),
                f"K1 != plain with winners of -1 and P ({what})")

    # zero chunks: an empty result, and no launch is made or counted
    before = dict(sc.LAUNCHES)
    s0 = torch.zeros((1, 8, 8), dtype=torch.float32, device=dev)
    e0 = torch.zeros((0, 4), dtype=torch.int32, device=dev)
    z = torch.zeros(0, dtype=torch.float32, device=dev)
    require(sc.surface_scan_events(s0, e0, e0, z, 1e-3).shape == (0, 1, 8, 8)
            and sc.surface_scan_tsmap(s0, e0.reshape(0, 1, 8, 8), z, e0[:, 0], 1e-3
                                      ).shape == (0, 1, 8, 8)
            and sc.LAUNCHES == before, "zero-chunk calls launched or counted")



def pool_check(dev) -> str:
    """maxpool_dense on the card against the same call on the CPU, equal
    element for element: int32 and bool (which cuDNN's pool does not take)
    and float32, 3-D and 4-D, 'VALID' and 'SAME' (asymmetric pads at the
    ragged edges).  Returns the line."""
    from async_ev_cnn_torch.ops.pool import maxpool_dense

    rng = np.random.RandomState(17)
    ints = rng.randint(-1000, 1000, (2, 16, 37, 53)).astype(np.int32)
    ints[0, 0, 0, :2] = (np.iinfo(np.int32).min, np.iinfo(np.int32).max)
    inputs = {"int32": ints, "bool": rng.rand(16, 37, 53) < 0.1,
              "float32": rng.randn(2, 16, 37, 53).astype(np.float32)}
    n = 0
    for name, a in inputs.items():
        cpu = torch.from_numpy(a)
        card = cpu.to(dev)
        for ksize, stride in (((2, 2), 2), ((3, 3), 2), ((3, 2), 1)):
            for padding in ("VALID", "SAME"):
                got = maxpool_dense(card, ksize, stride, padding)
                want = maxpool_dense(cpu, ksize, stride, padding)
                require(got.dtype == want.dtype and torch.equal(got.cpu(), want),
                        f"maxpool_dense {name} {ksize}/{stride} {padding}: card != CPU")
                n += 1
    return (f"pool: maxpool_dense on the card equal to the CPU on {n} cases (int32 "
            "[2, 16, 37, 53] with both extremes, bool [16, 37, 53], float32; (2, 2)/2, "
            "(3, 3)/2, (3, 2)/1; 'VALID' and 'SAME')")


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


def kernel_err(fn, plain, args, what: str) -> float:
    """max |kernel - plain| over both planes of a rulebook-style kernel,
    held to KERNEL_REL_TOL * (1 + max |plain|); a second launch on the same
    inputs must give the same bits (no atomics, a fixed summation order)."""
    got, again, want = fn(*args), fn(*args), plain(*args)
    torch.cuda.synchronize()
    require(all(bit_equal(g, a) for g, a in zip(got, again)),
            f"{what}: two launches on the same inputs differ")
    err = max(float((g - w_).abs().max()) for g, w_ in zip(got, want))
    tol = KERNEL_REL_TOL * (1 + max(float(w_.abs().max()) for w_ in want))
    require(err <= tol, f"{what} differs from its plain version by {err} > {tol}")
    return err


def gather_gemm_edges(dev) -> str:
    """K3, K4 and K5 at the gather-GEMM's edge shapes (GG_EDGES): K3 every
    block, K5 a repeated last row, K4 every site up to one past the last
    output row and column, against their plain versions and a second
    launch at 'highest' and 'default' ('highest' is restored whatever
    happens).  Returns the phase's line."""
    from async_ev_cnn_torch.ops import rows_gemm as tr
    from async_ev_cnn_torch.ops import rulebook_gemm as rg
    from async_ev_cnn_torch.ops.conv import set_matmul_precision

    rng = np.random.RandomState(11)
    worst, plans = {"K3": 0.0, "K4": 0.0, "K5": 0.0}, []
    try:
        for tier in ("highest", "default"):
            set_matmul_precision(tier)
            for what, hp, wp, c, o, kh, kw, off, stride in GG_EDGES:
                buf = torch.from_numpy(rng.randn(2, hp * wp * c + off).astype(np.float32)).to(dev)
                fm, ca = (buf[i, off:].view(hp, wp, c) for i in (0, 1))
                w = torch.from_numpy((rng.randn(kh, kw, c, o) * 0.1).astype(np.float32)).to(dev)
                b = torch.from_numpy(rng.randn(o).astype(np.float32)).to(dev)
                oh, ow = (hp - kh) // stride + 1, (wp - kw) // stride + 1
                ys = torch.arange(oh + 1, dtype=torch.int32, device=dev).repeat_interleave(ow + 1)
                xs = torch.arange(ow + 1, dtype=torch.int32, device=dev).repeat(oh + 1)
                cases = [("K4", partial(rg.rulebook_gather_gemm, stride=stride),
                          partial(rg.rulebook_gather_gemm_plain, stride=stride),
                          (fm, ca, w, b, ys, xs), ys.numel())]
                if stride == 1:
                    wb = -(-ow // rg.BLOCK_W)
                    by = torch.arange(oh, dtype=torch.int32, device=dev).repeat_interleave(wb)
                    bx = torch.arange(wb, dtype=torch.int32, device=dev).repeat(oh)
                    rows = torch.tensor([oh - 1, 0, oh // 2, oh - 1], dtype=torch.int32,
                                        device=dev)
                    cases += [("K3", rg.rulebook_gather_gemm_blocks,
                               rg.rulebook_gather_gemm_blocks_plain, (fm, ca, w, b, by, bx),
                               by.numel() * rg.BLOCK_W),
                              ("K5", tr.rows_gather_conv, tr.rows_gather_conv_plain,
                               (fm, ca, w, b, rows), rows.numel() * ow)]
                for name, fn, plain, args, m in cases:
                    worst[name] = max(worst[name], kernel_err(
                        fn, plain, args, f"{name} at {what} ({tier})"))
                    if tier == "highest":
                        plan = rg.gather_gemm_plan(m, o, kh, kw, c)
                        plans.append(f"{name} {what}: {plan_text(plan)}")
    finally:
        set_matmul_precision("highest")
    return (f"gather-gemm-edges: K3, K4 and K5 == plain within {KERNEL_REL_TOL} * "
            f"(1 + max|plain|) and bit-equal across two launches at 'highest' and 'default' "
            f"at {len(GG_EDGES)} edge shapes (K3 and K5 at the {sum(e[-1] == 1 for e in GG_EDGES)} "
            f"of stride 1); max abs err K3 {worst['K3']:.2e}, K4 {worst['K4']:.2e}, K5 "
            f"{worst['K5']:.2e}; plans: " + "; ".join(plans))


def rulebook_case(name, spec, kernel, bias, prev_io, dev):
    """One rulebook kernel call at a layer's shapes, from its real active
    mask: the kernel against its plain version at 'highest' and 'default'
    ('highest' is restored whatever happens), the times and the bound."""
    from async_ev_cnn_torch.ops import conv as tconv
    from async_ev_cnn_torch.ops import masks as tmasks
    from async_ev_cnn_torch.ops import rulebook_gemm as rg
    from async_ev_cnn_torch.ops.conv import set_matmul_precision

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
        plan = rg.gather_gemm_plan(by.numel() * rg.BLOCK_W, o, kh, kw, c)
    else:
        ys, xs, valid = tmasks.mask_to_topk_coords(active, spec.capacity)
        n_active = active.sum()
        args = (fm, ca, w_hwio, bias, ys, xs)
        kernel_fn, plain_fn = rg.rulebook_gather_gemm, rg.rulebook_gather_gemm_plain
        kwargs = {"stride": spec.stride}
        sites_per_box, box_w, cols_scale = 1, kw, spec.stride
        plan = rg.gather_gemm_plan(ys.numel(), o, kh, kw, c)
    err = kernel_err(partial(kernel_fn, **kwargs), partial(plain_fn, **kwargs), args,
                     f"{name}: {kernel_fn.__name__}")
    try:  # the 'default' tier: the kernel rounds its operands to TF32
        set_matmul_precision("default")
        default_err = kernel_err(partial(kernel_fn, **kwargs), partial(plain_fn, **kwargs),
                                 args, f"{name}: {kernel_fn.__name__} at 'default'")
    finally:
        set_matmul_precision("highest")
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

    def call():
        return kernel_fn(*args, **kwargs)

    return {
        "layer": name, "k": int(args[4].numel()), "valid": n_valid,
        "active": int(n_active), "c": c, "o": o,
        "err": err, "default_err": default_err, "plan": plan_text(plan),
        "ms": gg_device_ms(call, plan),
        "split_ms": split_pass_ms(call, plan),
        "call_ms": time_ms(lambda: kernel_fn(*args, **kwargs), 50),
        "plain_ms": time_ms(lambda: plain_fn(*args, **kwargs), 5),
        "dense_pair_ms": device_ms(lambda: tconv.conv2d_dense(
            pair, kernel, None, spec.stride, spec.padding)),
        "bound": bound_ms(n_bytes, n_ops),
    }


def rows_phase(dev, net, params, ios):
    """Phase 13: K5 at every conv layer's shapes from the real masks of the
    clustered stream, at 'highest' and at the 'default' tier ('highest' is
    restored whatever happens), then its path.  Returns K5's entry of the
    kernels' JSON line."""
    from async_ev_cnn_torch.ops import conv as tconv
    from async_ev_cnn_torch.ops import masks as tmasks
    from async_ev_cnn_torch.ops import rows_gemm as tr
    from async_ev_cnn_torch.ops import rulebook as trb
    from async_ev_cnn_torch.ops import rulebook_gemm as rg
    from async_ev_cnn_torch.ops.conv import set_matmul_precision

    layers = net.event_layers
    convs = [(ld, ios[layers[j - 1].name]) for j, ld in enumerate(layers) if ld.kind == "conv"]
    cases = []
    tier_err = 0.0
    for ld, prev_io in convs:
        spec = ld.spec
        kernel, bias = params[f"w_{ld.name}"], params[f"b_{ld.name}"].float().contiguous()
        active = tmasks.dilate_mask(prev_io.mask, spec.ksize, spec.stride, spec.pads)
        row_idx, row_valid, _ = trb.active_rows(active, spec.row_capacity)
        rows = row_idx.to(torch.int32)
        fm, ca = hwc_padded(spec, prev_io.featuremap), hwc_padded(spec, prev_io.conv_actfn)
        w_hwio = kernel.permute(2, 3, 1, 0).contiguous().float()
        args_ = (fm, ca, w_hwio, bias, rows)
        err = kernel_err(tr.rows_gather_conv, tr.rows_gather_conv_plain, args_,
                         f"{ld.name}: K5")
        try:  # the 'default' tier: the kernel rounds its operands to TF32
            set_matmul_precision("default")
            tier_err = max(tier_err, kernel_err(tr.rows_gather_conv, tr.rows_gather_conv_plain,
                                                args_, f"{ld.name}: K5 at 'default'"))
        finally:
            set_matmul_precision("highest")
        hp, wp, c = fm.shape
        kh, kw = spec.ksize
        o = kernel.shape[0]
        ow = wp - kw + 1
        plan = rg.gather_gemm_plan(rows.numel() * ow, o, kh, kw, c)
        # the work this mask needs: the valid rows' distinct input rows of
        # both planes, the weights, bias and row list, the valid rows'
        # outputs of both planes; one FFMA (2 flops) a term
        valid_rows = row_idx[row_valid].cpu().numpy()
        in_rows = len({int(r) + dy for r in valid_rows for dy in range(kh)})
        n_valid = len(valid_rows)
        n_bytes = 4 * (2 * in_rows * wp * c + kh * kw * c * o + o + rows.numel()
                       + 2 * n_valid * ow * o)
        n_ops = 2 * 2 * n_valid * ow * kh * kw * c * o
        # rows_conv_pair's own conv: one VALID conv over the [2R, C, kh, Wp]
        # stack of both planes' row windows
        take = row_idx[:, None] + torch.arange(kh, device=dev)[None, :]
        stack = torch.cat([fm[take], ca[take]]).permute(0, 3, 1, 2).contiguous()

        def forced(splits):  # the same call at another split count
            def call():
                outs = [torch.empty((rows.numel(), ow, o), dtype=torch.float32, device=dev)
                        for _ in range(2)]
                rg.launch_gather_gemm(*args_, None, *outs, "rows", ow=ow, splits=splits)
                return outs
            return call

        # the reduction left whole, and one split more than the plan's
        other = {s: forced(s) for s in (1, plan.splits + 1) if s <= plan.n_slices}
        for s, call in other.items():
            err = max(err, kernel_err(call, lambda: tr.rows_gather_conv_plain(*args_), (),
                                      f"{ld.name}: K5 at S={s}"))
        cases.append({
            "layer": ld.name, "r": rows.numel(), "valid": n_valid, "c": c, "o": o,
            "ow": ow, "err": err, "plan": plan_text(plan),
            "ms": gg_device_ms(lambda: tr.rows_gather_conv(*args_), plan),
            "split_ms": split_pass_ms(lambda: tr.rows_gather_conv(*args_), plan),
            "other_ms": {s: device_ms(call, GG_KERNELS, per_call=1 + (s > 1))
                         for s, call in other.items()},
            "plain_ms": time_ms(lambda: tr.rows_gather_conv_plain(*args_), 5),
            "library_ms": device_ms(lambda: tconv.conv2d_dense(
                stack, kernel, None, (1, 1), "VALID")),
            "bound": bound_ms(n_bytes, n_ops),
        })

    # the path: one chunk's 'sparse_rows' update of every layer through K5
    tr.reset_launches()
    path_err = 0.0
    for ld, prev_io in convs:
        spec = ld.spec
        active = tmasks.dilate_mask(prev_io.mask, spec.ksize, spec.stride, spec.pads)
        plane_args = (prev_io.featuremap, prev_io.conv_actfn, active,
                      params[f"w_{ld.name}"], params[f"b_{ld.name}"])
        got = tr.kernel_rows_conv_pair(*plane_args, spec.row_capacity, spec.pads)
        want = trb.rows_conv_pair(*plane_args, spec.stride, spec.row_capacity, spec.pads)
        require(all(torch.equal(got[i], want[i]) for i in (0, 1, 4)),
                f"{ld.name}: K5's rows differ from rows_conv_pair's")
        err = max(float((got[i] - want[i]).abs().max()) for i in (2, 3))
        tol = KERNEL_REL_TOL * (1 + max(float(want[i].abs().max()) for i in (2, 3)))
        require(err <= tol, f"{ld.name}: K5's 'sparse_rows' update differs from "
                f"rows_conv_pair's by {err} > {tol}")
        path_err = max(path_err, err)
    torch.cuda.synchronize()
    path_launches = tr.LAUNCHES["rows_gather_conv"]
    require(path_launches == len(convs),
            f"K5's path launched {path_launches} times for {len(convs)} layers")
    print("rows-kernel: K5 == plain within "
          f"{KERNEL_REL_TOL} * (1 + max|plain|) at every layer; " + "; ".join(
              f"{r['layer']} R={r['r']} ({r['valid']} valid) C={r['c']} O={r['o']} "
              f"ow={r['ow']} [{r['plan']}]: device {r['ms']:.4f} ms (split pass "
              f"{r['split_ms']:.4f}; " + "".join(f"at S={s} {t:.4f}; " for s, t in
                                                r['other_ms'].items())
              + f"plain {r['plain_ms']:.3f}, "
              f"rows_conv_pair's conv device {r['library_ms']:.4f}, bound "
              f"{r['bound'][0]:.5f} {r['bound'][1]}), err {r['err']:.2e}" for r in cases)
          + f"; path: the 'sparse_rows' update of one chunk through K5 at "
          f"{len(convs)} layers within {path_err:.2e} of rows_conv_pair, launches "
          f"{path_launches}; at 'default' (operands rounded to TF32) K5 within the same "
          f"tolerance of its plain version at every layer, max abs err {tier_err:.2e}",
          flush=True)
    b_bytes = sum(r["bound"][0] for r in cases if r["bound"][1] == "bytes")
    b_ops = sum(r["bound"][0] for r in cases if r["bound"][1] == "operations")
    return {"name": "rows_gather_conv", "route": "cuda",
            "source": "async_ev_cnn_torch/csrc/gather_gemm.cu",
            "replaces": "async_ev_cnn_tpu/ops/pallas_rows.py:92",
            "launches": path_launches, "max_abs_err": max(r["err"] for r in cases),
            "ms": sum(r["ms"] for r in cases), "plain_ms": sum(r["plain_ms"] for r in cases),
            "bound_ms": b_bytes + b_ops, "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "library_ms": sum(r["library_ms"] for r in cases)}


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

    # ---- 7. rulebook kernels at their edges and every conv layer's shapes -----
    print(gather_gemm_edges(dev), flush=True)
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
    # the same sites with 64 output channels: the wide tile's 64 columns all
    # live, where conv2's O = 32 masks half of them
    w64 = torch.from_numpy(np.random.RandomState(5).randn(64, *params["w_conv2"].shape[1:])
                           .astype(np.float32) * 0.05).to(dev)
    k4_o64 = rulebook_case("conv2/stride2 O=64", k4_spec._replace(out_channels=64), w64,
                           torch.zeros(64, dtype=torch.float32, device=dev), pool1_io, dev)
    print("rulebook-kernels: K3 == plain and K4 == plain within "
          f"{KERNEL_REL_TOL} * (1 + max|plain|) at 'highest' and 'default', and bit-equal "
          "across two launches, at "
          f"chunk {WARM_CHUNKS} of the clustered stream; " + "; ".join(
              f"{r['layer']} K={r['k']} ({r['valid']} valid of {r['active']} active) "
              f"C={r['c']} O={r['o']} [{r['plan']}]: "
              f"device {r['ms']:.4f} ms (split pass {r['split_ms']:.4f}, a call "
              f"{r['call_ms']:.4f}, plain "
              f"{r['plain_ms']:.3f}, dense pair device {r['dense_pair_ms']:.4f}, bound "
              f"{r['bound'][0]:.5f} {r['bound'][1]}), "
              f"err {r['err']:.2e} ('default' {r['default_err']:.2e})"
              for r in k3 + [k4, k4_o64]), flush=True)

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
              if any(k in e.key for k in GG_KERNELS)]
    top = sorted(parts, key=lambda e: -e[2])[:10]
    print(f"seq-syncs: one sequential chunk makes {n_syncs} synchronizing CUDA calls "
          f"(torch.cuda sync debug mode); the conv layers count {n_reads} flag reads",
          flush=True)
    print(f"seq-profile: one sequential chunk under torch.profiler: wall {wall_ms:.2f} ms, "
          f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% of wall); device "
          "time by op: " + "; ".join(f"{k[:60]} x{n} {us / 1e3:.3f} ms" for k, n, us in top),
          flush=True)

    k5 = rows_phase(dev, net, params, ios)

    def total(key):
        return sum(r[key] for r in k3)

    k3_bytes_ms = sum(r["bound"][0] for r in k3 if r["bound"][1] == "bytes")
    k3_ops_ms = sum(r["bound"][0] for r in k3 if r["bound"][1] == "operations")
    return [
        {"name": "rulebook_gather_gemm_blocks", "route": "cuda",
         "source": "async_ev_cnn_torch/csrc/gather_gemm.cu",
         "replaces": "async_ev_cnn_tpu/ops/pallas_rulebook_blocks.py:94",
         "launches": seq_launches["rulebook_gather_gemm_blocks"],
         "max_abs_err": max(r["err"] for r in k3), "ms": total("ms"),
         "plain_ms": total("plain_ms"), "bound_ms": k3_bytes_ms + k3_ops_ms,
         "bound_by": "bytes" if k3_bytes_ms >= k3_ops_ms else "operations",
         # no single PyTorch call gathers and multiplies at the active sites
         "library_ms": None, "dense_pair_ms": total("dense_pair_ms"),
         "call_ms": total("call_ms")},
        {"name": "rulebook_gather_gemm", "route": "cuda",
         "source": "async_ev_cnn_torch/csrc/gather_gemm.cu",
         "replaces": "async_ev_cnn_tpu/ops/pallas_rulebook.py:97",
         "launches": k4_launches["rulebook_gather_gemm"], "max_abs_err": k4["err"],
         "ms": k4["ms"], "plain_ms": k4["plain_ms"], "bound_ms": k4["bound"][0],
         "bound_by": k4["bound"][1], "library_ms": None,
         "dense_pair_ms": k4["dense_pair_ms"], "call_ms": k4["call_ms"],
         "split_ms": k4["split_ms"], "plan": k4["plan"], "o64_ms": k4_o64["ms"]},
        k5,
    ]


def k6_check(x, taps, bias, alpha, what: str) -> float:
    """K6 against its plain version within K6_TOL * (1 + max|plain|), and
    bit-equal across two launches.  Returns the max abs error."""
    from async_ev_cnn_torch.ops import fused_stem as tf

    got, again = tf.fused_stem(x, taps, bias, alpha), tf.fused_stem(x, taps, bias, alpha)
    want = tf.fused_stem_plain(x, taps, bias, alpha)
    torch.cuda.synchronize()
    require(bit_equal(got, again), f"K6 at {what}: two launches on the same inputs differ")
    err = float((got - want).abs().max())
    tol = K6_TOL * (1 + float(want.abs().max()))
    require(err <= tol, f"K6 at {what} differs from its plain version by {err} > {tol}")
    return err


def stem_kernel_phase(dev, model, c0):
    """Phase 14: K6 on the T=200 surfaces of a full-width dispatch, against
    its plain version, fused_conv_pool and the direct conv1 -> pool1, then
    at its edge shapes (K6_EDGES).  Returns K6's entry of the kernels' JSON
    line."""
    from async_ev_cnn_torch.ops import conv as tconv
    from async_ev_cnn_torch.ops import fused_stem as tf
    from async_ev_cnn_torch.ops import pool as tpool
    from async_ev_cnn_torch.ops import stem as tstem
    from async_ev_cnn_torch.ops.integrate import integrate_parallel

    st0 = model.init_state()
    surfaces, _ = integrate_parallel(st0[0].surface, st0[0].prev_ts, c0, LEAK)
    x = surfaces[:, 0].contiguous()                                  # [T, H, W]
    w1, b1 = model.params["w_conv1"], model.params["b_conv1"].float().contiguous()
    taps = tf.w_taps_from_oihw(w1)
    # the path: one fused stem over the dispatch's surfaces
    tf.reset_launches()
    got = tf.fused_stem(x, taps, b1, 0.1)
    torch.cuda.synchronize()
    launches = tf.LAUNCHES["fused_stem"]
    require(launches == 1, f"K6's path launched {launches} times")
    err = k6_check(x, taps, b1, 0.1, "full width")
    fused = tstem.fused_conv_pool(surfaces, w1, b1, 0.1)
    direct = model.net.full_frame_forward(model.params, st0, surfaces, upto=2)
    torch.cuda.synchronize()
    err_f = float((got - fused).abs().max())
    err_d = float((got - direct).abs().max())
    require(err_f <= 1e-5 and err_d <= 1e-5,
            f"K6 differs from fused_conv_pool by {err_f}, from the direct stem by {err_d}")
    # the edge shapes, each against the plain version, a second launch and
    # both library stems
    rng = np.random.RandomState(13)
    edges = []
    for what, t_e, h_e, w_e, o_e, alpha in K6_EDGES:
        xe = torch.from_numpy((rng.rand(t_e, h_e, w_e) * 2).astype(np.float32)).to(dev)
        ke = torch.from_numpy((rng.randn(o_e, 1, 3, 3) * 0.3).astype(np.float32)).to(dev)
        be = torch.from_numpy((rng.randn(o_e) * 0.1).astype(np.float32)).to(dev)
        e_err = k6_check(xe, tf.w_taps_from_oihw(ke), be, alpha, what)
        if alpha <= 1:  # the library stems' max(x, alpha * x) is the same activation
            got_e = tf.fused_stem(xe, tf.w_taps_from_oihw(ke), be, alpha)
            lib = (tstem.fused_conv_pool(xe[:, None], ke, be, alpha),
                   tpool.maxpool_dense(tconv.leaky(tconv.conv2d_dense(
                       xe[:, None], ke, be, 1, "SAME"), alpha), (2, 2), 2))
            lib_err = max(float((got_e - y).abs().max()) for y in lib)
            require(lib_err <= 1e-5, f"K6 at {what} differs from the library stems by {lib_err}")
        edges.append(f"{what} (T={t_e} {h_e}x{w_e} O={o_e} alpha={alpha}) {e_err:.2e}")
        err = max(err, e_err)
    t, h, w = x.shape
    o = taps.shape[1]

    def call():
        return tf.fused_stem(x, taps, b1, 0.1)

    times = {
        # a call's device time: the kernel and the taps' two copies into
        # its constant block
        "ms": device_ms(call),
        "kernel_ms": device_ms(call, "fused_stem_kernel"),
        "call_ms": time_ms(call, 50),
        "plain_ms": time_ms(lambda: tf.fused_stem_plain(x, taps, b1, 0.1), 3),
        "library_ms": device_ms(lambda: model.net.full_frame_forward(
            model.params, st0, surfaces, upto=2)),
        "fused_conv_pool_ms": device_ms(lambda: tstem.fused_conv_pool(surfaces, w1, b1, 0.1)),
    }
    b_ms, b_by = bound_ms(4 * (t * h * w + 10 * o + t * o * (h // 2) * (w // 2)),
                          2 * 9 * t * o * h * w)
    print(f"stem-kernel: K6 over the {t} surfaces of a dispatch (C=1 {h}x{w}, O={o}): "
          f"within {K6_TOL} * (1 + max|plain|) of its plain version and bit-equal across two "
          f"launches (max abs err {err:.2e} over the dispatch and the edges: "
          + "; ".join(edges) + f"), within {err_f:.2e} of fused_conv_pool and "
          f"{err_d:.2e} of the direct 'full' conv1 -> pool1 (the edges with alpha <= 1 within "
          "1e-5 of both); "
          f"K6 device {times['ms']:.4f} ms a call (kernel {times['kernel_ms']:.4f}, a call by "
          f"events {times['call_ms']:.4f}; plain {times['plain_ms']:.3f}, direct stem device "
          f"{times['library_ms']:.4f}, fused_conv_pool device "
          f"{times['fused_conv_pool_ms']:.4f}, bound {b_ms:.5f} {b_by}); launches "
          f"{launches}", flush=True)
    return {"name": "fused_stem", "route": "cuda",
            "source": "async_ev_cnn_torch/csrc/fused_stem.cu",
            "replaces": "examples/pallas_stem_negative.py:74", "launches": launches,
            "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by, **times}


def gather_copy_phase(dev):
    """Phase 15: K7 against its plain version on every shape, then the slope
    table.  Returns K7's entry of the kernels' JSON line."""
    from async_ev_cnn_torch.scripts import dma_microbench as dmb

    inputs = dmb.make_inputs(0, dev)
    small = dmb.check_against_plain(inputs)
    require(all(e == 0.0 for _, _, e in small), f"K7 differs from its plain version: {small}")
    n_copies, g1, g2 = 8, 4096, 16384
    # the path: the microbenchmark's slope table, counted
    dmb.reset_launches()
    table = dmb.slope_table(inputs, n_copies, g1, g2)
    torch.cuda.synchronize()
    launches = dmb.LAUNCHES["gather_copy"]
    require(launches == len(table) * 2 * 5, f"K7's path launched {launches} times")
    # every row of the table at its larger grid, where box_sp / rows_sp wrap
    # around the 16384 corners and flat's offsets around the source
    large = dmb.check_against_plain(inputs, g2, n_copies)
    require(all(e == 0.0 for _, _, e in large),
            f"K7 differs from its plain version at grid {g2} x {n_copies}: {large}")
    print(f"gather-copy: K7 == plain bit for bit on all {len(small)} (shape, kh) rows at grid 4 "
          f"x 2 copies and at grid {g2} x {n_copies}; slope between grids {g1} and {g2} x "
          f"{n_copies} copies (the 171 MB "
          "source exceeds the 50 MB L2; box_sp/rows_sp revisit 16384 corners): " + "; ".join(
              f"{r['shape']} kh={r['kh']} {r['us_per_copy']:.4f} us/copy "
              f"{r['us_per_row']:.4f} us/row {r['gb_s']:.1f} GB/s "
              f"({100 * r['share']:.1f}% of 3.35 TB/s)" for r in table)
          + f"; launches {launches}", flush=True)
    # the entry: one call of the box shape at kh=3 and grid g2
    ref = next(r for r in table if r["shape"] == "box" and r["kh"] == 3)
    n_bytes = g2 * n_copies * dmb.copy_bytes("box", 3) + 4 * (g2 + 1) * dmb.C
    b_ms, b_by = bound_ms(n_bytes, g2 * dmb.C)
    return {"name": "gather_copy", "route": "cuda",
            "source": "async_ev_cnn_torch/csrc/gather_copy.cu",
            "replaces": "examples/dma_microbench.py:152", "launches": launches,
            "max_abs_err": max(e for _, _, e in small + large), "ms": ref["t_g2_ms"],
            "plain_ms": time_ms(lambda: dmb.run_plain(*inputs, g2, n_copies, "box", 3), 1, 2),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "slope": [{k: r[k] for k in ("shape", "kh", "us_per_copy", "gb_s")} for r in table]}


def dispatch_rate(net, params, c0, n: int = 4):
    """events/s and the outputs of ``n`` timed scan_parallel dispatches of
    the chunks ``c0`` from the initial state (after one warm-up)."""
    st = net.init_state(params, c0.y.device)
    _, out = net.scan_parallel(params, st, c0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        _, out = net.scan_parallel(params, st, c0)
    torch.cuda.synchronize()
    return n * int(c0.valid.sum()) / (time.perf_counter() - t0), out


def stem_path_phase(model, c0, smi):
    """Phase 16: the parallel path unfused against stem_fusion=True at
    'highest'."""
    from async_ev_cnn_torch.ops import stem as tstem

    net, params = model.net, model.params
    fused_net = net.with_stem_fusion(True)
    require(not net._fusion_active() and fused_net._fusion_active(),
            "at 'highest' 'auto' must not fuse and True must")
    rates = {"unfused": [], "fused": []}
    outs = {}
    tstem.reset_calls()
    for name in ("unfused", "fused", "fused", "unfused"):
        rate, outs[name] = dispatch_rate(fused_net if name == "fused" else net, params, c0)
        rates[name].append(rate)
    calls = tstem.CALLS["fused_conv_pool"]
    require(calls == 2 * 5, f"the fused pair's conv ran {calls} times in 10 fused dispatches")
    err = float((outs["fused"] - outs["unfused"]).abs().max())
    require(err <= 1e-5, f"the fused stem path differs from the unfused one by {err}")
    print(f"stem-path: scan_parallel at 'highest', T={T_CHUNKS}: stem_fusion=True within "
          f"{err:.2e} of the unfused path; events/s unfused "
          f"{', '.join(f'{r:.0f}' for r in rates['unfused'])}, fused "
          f"{', '.join(f'{r:.0f}' for r in rates['fused'])} (runs in the order unfused, "
          f"fused, fused, unfused); the fused pair's conv ran {calls} times in 10 fused "
          f"dispatches; card {smi!r}", flush=True)


def tier_phase(dev, args, layer_defs, num_classes, num_bbox, c0, smi):
    """Phase 17: the tiers and bf16 activations on the parallel path and the
    full-width gate; 'highest' is restored whatever happens."""
    from async_ev_cnn_torch.models.yolo import YoloEventTorch
    from async_ev_cnn_torch.ops import stem as tstem
    from async_ev_cnn_torch.ops.conv import set_matmul_precision
    from async_ev_cnn_torch.utils.equivalence import make_stream, run_equivalence

    weights = make_params(layer_defs, np.random.RandomState(0))

    def model(mode, act="float32"):
        m = YoloEventTorch(
            args.frame_h, args.frame_w, num_classes, layer_defs, args.yolo_cnn_padding,
            args.yolo_num_cells_h, args.yolo_num_cells_w, num_bbox, alpha=0.1,
            leak=args.leak, conv_mode=mode, capacity_frac=CAPACITY_FRAC,
            activation_dtype=act, device=dev)
        m.set_weights(weights)
        return m

    gate_chunks = make_stream(np.random.RandomState(0), TIER_GATE_STEPS, 200, H, W,
                              max_dt=30, device=dev)
    lines = []
    try:
        for tier, act in (("highest", "float32"), ("high", "float32"),
                          ("default", "float32"), ("default", "bfloat16")):
            set_matmul_precision(tier)
            full = model("full", act)
            tstem.reset_calls()
            rate_auto, out_auto = dispatch_rate(full.net, full.params, c0)
            fused = tstem.CALLS["fused_conv_pool"] > 0
            require(fused == full.net._fusion_active()
                    and fused == (tier == "default" and act == "float32"),
                    f"'auto' fused={fused} at {tier}/{act}")
            unfused = full.net.with_stem_fusion(False)
            rate_off, out_off = dispatch_rate(unfused, full.params, c0)
            diff = float((out_auto - out_off).abs().max())
            gate = {}
            for mode in ("full", "dense") + (("sparse_pallas",) if (tier, act) == (
                    "default", "float32") else ()):
                m = full if mode == "full" else model(mode, act)
                rep = run_equivalence(m.net, m.params, gate_chunks, device=dev)
                gate[mode] = max(rep.max_diff.values())
            require(gate["full"] <= OUT_TOL, f"{tier}/{act}: 'full' gate {gate['full']}")
            if tier != "default":
                require(gate["dense"] <= OUT_TOL, f"{tier}/{act}: 'dense' gate {gate['dense']}")
            lines.append(
                f"{tier}/{act}: {rate_auto:.0f} events/s under 'auto' ({'fused' if fused else 'not fused'}; "
                f"stem_fusion=False {rate_off:.0f}, outputs {diff:.2e} apart); gate over "
                f"{TIER_GATE_STEPS} steps " + ", ".join(f"{k} {v:.3e}" for k, v in gate.items()))
    finally:
        set_matmul_precision("highest")
    require(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
            "TF32 still on after the tiers")
    print("tiers: " + "; ".join(lines) + f"; card {smi!r}", flush=True)


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
    from async_ev_cnn_torch.utils.equivalence import make_stream
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
    sources = ("surface_scan", "gather_gemm", "fused_stem", "gather_copy")
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
    sass = sass_loop_cost(cuda_build.library_path("fused_stem"), K6_HOT_INSTANCE)
    print("sass: " + ("cuobjdump not found" if sass is None else
                      f"K6 {sass[0]}: hot loop {sass[1]} instructions, {sass[2]} FFMA/FADD, "
                      f"{sass[3]:.1f} instructions a pooled pixel and channel"), flush=True)

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
    # the winner lists of a clustered stream: most winners in a few tiles
    cl_chunks = make_stream(np.random.RandomState(4), T_CHUNKS, CAPACITY, H, W, max_dt=15,
                            clustered=True, cluster_radius=8, device=dev)
    cpix, cdt, cd, _ = it.chunk_event_updates(1, H, W, prev, cl_chunks, LEAK)
    cts_map, cd2, clt = it.chunk_ts_maps(1, H, W, prev, cl_chunks, LEAK)
    k1c = sc.surface_scan_events(s0, cpix, cdt, cd, LEAK)
    torch.cuda.synchronize()
    require(bit_equal(k1c, sc.surface_scan_events_plain(s0, cpix, cdt, cd, LEAK)),
            "K1 != its plain version on the clustered lists")
    require(bit_equal(k1c, sc.surface_scan_tsmap(s0, cts_map, cd2, clt, LEAK)),
            "K1 != K2 on the clustered lists")
    check_kernels_small(dev)
    err1 = float((k1 - p1).abs().max())
    err2 = float((k2 - p2).abs().max())

    t_len, e_len = pix.shape
    p_len = H * W
    plan = sc.scan_events_plan(t_len, e_len, p_len)

    def winners(q):  # winners of the busiest tile (a dispatch), and of all
        q = q[q >= 0]
        return int(torch.bincount(q // plan.tile).max()), int(q.numel())

    def k1_call(lists):
        return lambda: sc.surface_scan_events(s0, *lists, LEAK)

    uniform, clustered = (pix, dt, d), (cpix, cdt, cd)
    k1_info = {
        "ms": device_ms(k1_call(uniform), K1_KERNELS, per_call=2),
        "bin_ms": device_ms(k1_call(uniform), "bin_events_kernel"),
        "clustered_ms": device_ms(k1_call(clustered), K1_KERNELS, per_call=2),
        "clustered_bin_ms": device_ms(k1_call(clustered), "bin_events_kernel"),
        "call_ms": time_ms(k1_call(uniform), 50),
        "plain_ms": time_ms(lambda: sc.surface_scan_events_plain(s0, pix, dt, d, LEAK), 3),
        "front_ms": device_ms(lambda: it.chunk_event_updates(1, H, W, prev, chunks, LEAK)),
        "clustered_front_ms": device_ms(
            lambda: it.chunk_event_updates(1, H, W, prev, cl_chunks, LEAK)),
        "hot": {"uniform": winners(pix), "clustered": winners(cpix)},
    }
    # surfaces written, surface + winner lists + decrements read
    k1_info["bound"] = bound_ms(4 * (t_len * p_len + p_len + 2 * t_len * e_len + t_len),
                                4 * t_len * p_len + 6 * t_len * e_len)
    k2_plan = sc.scan_tsmap_plan(t_len, p_len)

    def k2_call():
        return sc.surface_scan_tsmap(s0, ts_map, d2, lt2, LEAK)

    k2_info = {
        "ms": device_ms(k2_call, "scan_tsmap_kernel"),
        "call_ms": time_ms(k2_call, 50),
        "plain_ms": time_ms(lambda: sc.surface_scan_tsmap_plain(s0, ts_map, d2, lt2, LEAK), 3),
        # ts maps read and surfaces written, surface + scalars read
        "bound": bound_ms(4 * (2 * t_len * p_len + p_len + 2 * t_len), 10 * t_len * p_len),
    }
    print("kernels: K1 == plain, K2 == plain, K1 == K2 bit for bit at "
          f"C=1 {H}x{W} T={t_len} E={e_len} on the uniform and the clustered lists; ragged "
          "2-channel (one across two of K1's windows and three of K2's), two of K2's "
          "windows and tiles, -1/P winners, large-dt and "
          f"iterated-integrate_step cases bit-equal; K1 [tile {plan.tile}, window "
          f"{plan.window}: {plan.n_tiles} tiles, {plan.n_windows} windows] device "
          f"{k1_info['ms']:.4f} ms uniform (binning pass {k1_info['bin_ms']:.4f}), "
          f"{k1_info['clustered_ms']:.4f} ms clustered (binning pass "
          f"{k1_info['clustered_bin_ms']:.4f}); busiest tile "
          f"{k1_info['hot']['uniform'][0]} of {k1_info['hot']['uniform'][1]} winners uniform, "
          f"{k1_info['hot']['clustered'][0]} of {k1_info['hot']['clustered'][1]} clustered; "
          f"a call {k1_info['call_ms']:.4f} ms, plain {k1_info['plain_ms']:.3f} ms, bound "
          f"{k1_info['bound'][0]:.4f} ms {k1_info['bound'][1]}; chunk_event_updates (the "
          f"winner dedup) device {k1_info['front_ms']:.4f} ms uniform, "
          f"{k1_info['clustered_front_ms']:.4f} clustered; K2 [tile {k2_plan.tile}, window "
          f"{k2_plan.window}: {k2_plan.n_tiles} tiles, {k2_plan.n_windows} windows] device "
          f"{k2_info['ms']:.4f} ms (a call {k2_info['call_ms']:.4f} ms, plain "
          f"{k2_info['plain_ms']:.3f} ms, bound {k2_info['bound'][0]:.6f} "
          f"ms); card {smi!r}", flush=True)
    del k1c, p1, p2, ts_map, cts_map

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
    print(pool_check(dev), flush=True)

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
              if any(k in e.key for k in K1_KERNELS + ("scan_tsmap_kernel",))]
    top = sorted(parts, key=lambda e: -e[2])[:10]
    print(f"profile: one T={T_CHUNKS} dispatch under torch.profiler: wall {wall_ms:.2f} ms, "
          f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% of wall); device "
          "time by op: " + "; ".join(f"{k[:60]} x{n} {us / 1e3:.3f} ms" for k, n, us in top),
          flush=True)

    rulebook_kernels = incremental_phases(dev, args, layer_defs, num_classes, num_bbox, smi)
    stem_kernel = stem_kernel_phase(dev, model, c0)
    gather_copy = gather_copy_phase(dev)
    stem_path_phase(model, c0, smi)
    tier_phase(dev, args, layer_defs, num_classes, num_bbox, c0, smi)

    scans = [
        {"name": "surface_scan_events", "replaces": "async_ev_cnn_tpu/ops/pallas_scan.py:273",
         # K1's launches come from the main path's run, K2's from its own path
         "launches": main_launches["surface_scan_events"], "max_abs_err": err1,
         **{k: v for k, v in k1_info.items() if k not in ("bound", "hot")}},
        {"name": "surface_scan_tsmap", "replaces": "async_ev_cnn_tpu/ops/pallas_scan.py:105",
         "launches": tsmap_launches["surface_scan_tsmap"], "max_abs_err": err2,
         **{k: v for k, v in k2_info.items() if k != "bound"}},
    ]
    kernels = []
    for entry, bound in zip(scans, (k1_info["bound"], k2_info["bound"])):
        kernels.append({
            "route": "cuda", "source": "async_ev_cnn_torch/csrc/surface_scan.cu", **entry,
            "bound_ms": bound[0], "bound_by": bound[1],
            # no single PyTorch call computes the T-step clamped recurrence
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels + rulebook_kernels + [stem_kernel, gather_copy]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


def kernel_times() -> dict:
    """K2 and K6 at the main path's shapes by device time, with the
    package that ``sys.path`` finds: the worker of :func:`compare`.  Only
    the wrappers' public calls, which a parent commit shares."""
    from async_ev_cnn_torch.ops import cuda_build
    from async_ev_cnn_torch.ops import fused_stem as tf
    from async_ev_cnn_torch.ops import integrate as it
    from async_ev_cnn_torch.ops import surface_scan as sc
    from async_ev_cnn_torch.utils.runner import pack_chunks

    import async_ev_cnn_torch

    dev = torch.device("cuda", 0)
    cuda_build.load_all(("surface_scan", "fused_stem"))
    rng = np.random.RandomState(0)
    chunks = pack_chunks(synth_stream(rng, T_CHUNKS, CAPACITY), CAPACITY, device=dev)
    s0 = torch.zeros((1, H, W), dtype=torch.float32, device=dev)
    prev = torch.tensor(0, dtype=torch.int32, device=dev)
    ts_map, d, lt = it.chunk_ts_maps(1, H, W, prev, chunks, LEAK)
    x = it.integrate_parallel(s0, prev, chunks, LEAK)[0][:, 0].contiguous()
    wr = np.random.RandomState(1)
    taps = tf.w_taps_from_oihw(torch.from_numpy(
        (wr.randn(16, 1, 3, 3) * 0.05).astype(np.float32)).to(dev))
    bias = torch.from_numpy((wr.randn(16) * 0.05).astype(np.float32)).to(dev)

    def k2():
        return sc.surface_scan_tsmap(s0, ts_map, d, lt, LEAK)

    def k6():
        return tf.fused_stem(x, taps, bias, 0.1)

    sass = sass_loop_cost(cuda_build.library_path("fused_stem"), K6_HOT_INSTANCE)
    if sass is None or "ILi16E" not in sass[0]:  # a tree without the template
        sass = sass_loop_cost(cuda_build.library_path("fused_stem"), "fused_stem_kernel")
    return {"package": str(Path(async_ev_cnn_torch.__file__).resolve().parent),
            "k2_ms": device_ms(k2, "scan_tsmap_kernel"), "k2_call_ms": time_ms(k2, 50),
            "k6_ms": device_ms(k6), "k6_kernel_ms": device_ms(k6, "fused_stem_kernel"),
            "k6_call_ms": time_ms(k6, 50),
            "k6_sass_per_px_ch": None if sass is None else sass[3]}


def compare(parent: Path) -> int:
    """K2 and K6 of the checkout at ``parent`` against this one's on one
    card, in the order parent, this, this, parent: each a process of its
    own that imports its tree's package and builds its kernels."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    rows = []
    for tree in (parent, HERE, HERE, parent):
        proc = subprocess.run([sys.executable, str(HERE / "chip_smoke.py"), "--kernel-times",
                               str(tree)], capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        rows.append({"tree": "parent" if tree == parent else "change",
                     **json.loads(proc.stdout.strip().splitlines()[-1])})
        print(json.dumps(rows[-1]), flush=True)
    print(f"compare: card {smi!r}; " + "; ".join(
        f"{r['tree']}: K2 device {r['k2_ms']:.5f} ms (a call {r['k2_call_ms']:.4f}), K6 device "
        f"{r['k6_ms']:.5f} ms (kernel {r['k6_kernel_ms']:.5f}, a call {r['k6_call_ms']:.4f}, "
        f"SASS a pooled pixel and channel {r['k6_sass_per_px_ch']})" for r in rows))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--kernel-times":
        # the package of the tree named, ahead of this file's own
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
        print(json.dumps(kernel_times()))
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == "--compare":
        sys.exit(compare(Path(sys.argv[2]).resolve()))
    sys.exit(main())
