#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (async_ev_cnn_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

``python3 chip_smoke.py --compare PARENT`` instead times K2 and K6 (device
time, and K6's SASS count), phase 4's path (events/s of three runs of
15 timed dispatches) and the eFCN's scan_parallel unwindowed and with
window budgets of 256 and 1024 MB (ms a call, window, peak) of the
checkout at PARENT against this one's on one card, in the order parent,
this, this, parent.  On a machine with two
cards or more phase 33 runs its NCCL branch.

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
   dispatches, the first eager, the second captured as a CUDA graph and
   every later one replayed; the same 16 run eagerly (K1, K6, C1 and E1
   counted a dispatch), each replayed dispatch bit-equal to its eager
   one; a replay's kernels counted by name in a torch.profiler trace;
   then the ts-map engine's path (K2), one full-width
   EventNetwork.scan_parallel(integrate_engine='tsmap') dispatch.  The
   launch counts are set to 0 just before each path and read just after
   it, and each kernel's count is its own path's (a replay launches
   through no wrapper: the graph path counts its eager dispatch and its
   capture);
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
14. K6 (fused_stem) on the T=200 surfaces of a full-width dispatch,
    within K6_TOL * (1 + max |plain|) of its plain version (K6_TOL is
    ops/fused_stem.py's, 1e-6) and bit-equal across two launches and to
    the network's stem (full_frame_forward's conv1 -> pool1, which runs
    K6), within K6_TOL * (1 + max |library|) of
    the library stem (cuDNN's conv and the pooled epilogue) and 1e-5 of
    fused_conv_pool at 'highest'; the same at its edge shapes (K6_EDGES:
    T = 1, H/2 not a multiple of the band, W/2 odd, O = 1 and 64, alpha < 0
    and > 1, the library stems where alpha <= 1); the device times of all
    four; then K6 against the library stem at a served dispatch's 1,024
    frames, the eFCN's 160x224 and YOLOv3-tiny's 416x416 (K6_DISPATCHES):
    within K6_TOL * (1 + max |library|), and the device time of both
    beside K6's bound;
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

Then the checkpoints, the frame detector, ts_window and the max-plus
engine, on the same full-width eFCN and seeded weights:

18. checkpoint: the weights written by save_params (.npz) and
    save_params_tf (TF bundle) under a temporary directory, each loaded by
    YoloEventTorch(checkpoint=...) (the load timed): parameters bit-equal
    to the set_weights model's; its path, one T=200 dispatch of each model
    through scan (K1, counted), grids and surfaces bit-equal; the stream
    state saved after that dispatch and restored, the next dispatch
    bit-equal to the uninterrupted run;
19. frame: integrate_frame chained per chunk on the card over one
    dispatch's events, bit-equal to the event path's surfaces;
    YoloFrameTorch at 'highest' on every frame (frames/s and p50 ms a frame
    by CUDA events), within 1e-4 of YoloEventTorch's 'full' grids at the
    same chunk boundaries and of itself on the CPU (3 frames); the dense
    'numpy' chain against YoloFrameNumpy within 1e-4 (2 frames); then
    head.decode, nms_torch on the card keeping the boxes nms keeps on the
    host (3 frames), decode_predictions on the card equal to the host's,
    and evaluate_detections against seeded synthetic boxes;
20. ts-window: scan_parallel(ts_window=(16, 16), integrate_engine='tsmap')
    on a clustered stream (radius 8), on a dispatch whose chunks all fit
    the window and on one where a chunk overflows it: K2 launched once on
    each (counted), surfaces bit-equal and outputs within 1e-4 of the
    'events' engine's;
21. maxplus: the T=200 dispatch through integrate_parallel(engine='maxplus')
    within 1e-6 of 'events', a scan_parallel dispatch through it within
    1e-4, and the device time of both engines' integrate calls beside
    phase 3's K1 and winner dedup.

Then the serving deployment (phase 23 runs right after phase 3, beside
the one-stream kernels):

22. wire: a T=200 stream fitting each tier (ultra4, ultra, compact,
    plain), with and without polarity: the 'auto' ladder settles on that
    tier, the planes go to the card through pinned staging buffers and
    decode there equal to the CPU decode on every field; bytes an event,
    the upload's and the decode's time;
23. K1 with a stream axis: S = 8 streams of T = 200 chunks of 256 winners
    at full width, bit-equal to its plain version and to 8 one-stream
    calls, one binning and one scan launch a call (counted), its device
    time against the 8 one-stream calls' and its bytes bound;
24. serving (this slice's main path): StreamingPipeline(streams=S,
    wire='auto', max_in_flight=2) at full width, 64 chunks a stream a
    dispatch, 12 dispatches, S = 1, 8 and 16, the counts set to 0 just
    before each run and read just after (one K1 call a dispatch, on the
    stream axis for S > 1): the first dispatch's K1 call bit-equal to its
    plain version on the same inputs (at S = 1 the eager dispatches and
    the capture counted, every dispatch bit-equal to an eager pipeline's);
    aggregate events/s, p50 dispatch latency, the tier settled on; at S = 8 the end surfaces bit-equal and
    the decoded outputs within 1e-4 of 8 one-stream pipelines;
25. serve CLI: scripts.serve (its main) on a synthetic n-data tree under a
    temporary directory with seeded weights, --num_streams 4
    --serve_chunks 64 --out, counted, its first K1 call bit-equal to its
    plain version on the same inputs, and once more without --out; then a
    --serve_state stop after one
    dispatch and a resume, whose detections and saved state are bit-equal
    to one pipeline serving the split twice without the stop;
26. data plane: native/evio.cc built with g++ into build/native (phase 2,
    beside nvcc) and held bit-equal to the numpy codecs (n-data files and
    batch, EVT3, CRC-32C); device_prefetch delivering 16 pinned batches to
    the card in order.

Then training and the train, evaluate and run_networks CLIs, at full width
(one n-data tree under a temporary directory for phases 28 and 29, written
by phase 25's writer with 8 train examples):

27. trainer: models/train.Trainer on configs/efcn_event.yml's eFCN with 100
    classes (C + B*5 = conv7's 110), the train CLI's seeded init, batches
    of 16 frames integrated on the card from seeded uniform streams with
    build_targets boxes: the first step's loss within 1e-5 of the same
    step on the CPU at 'highest', and every gradient within 1e-4 of each
    tensor's largest of the CPU's with its max-pools routed as on the card
    (a pool's gradient jumps where window values tie to rounding; the
    windows routed otherwise, and the plain CPU step's distance, are
    printed), the cuDNN/cuBLAS TF32 and cuDNN deterministic flags the
    backward ran under (read by a gradient hook), and the distance at
    'default'; 30 Adam steps at 'highest' and 'default' (the loss finite
    and falling; median ms a step over steps 10-30 by CUDA events,
    frames/s, peak device memory) and at 'highest' without cuDNN's
    deterministic choice; 8 steps against 4, .npz + .opt.npz, a fresh
    Trainer resumed from them and 4 more: parameters and Adam moments
    bit-equal;
28. train + evaluate CLIs: scripts.train (4 steps of batch 4,
    --checkpoint_every 2), --resume_from for 2 more (Adam count 6), then
    scripts.evaluate on the resumed checkpoint in 'dense' and in
    'sparse_pallas' (K3/K4 counted: K3 only, the eFCN's convs are stride
    1; the first K3 call within 1e-5 * (1 + max |plain|) of its plain
    version): each run's JSON line and wall time;
29. run_networks CLI: the step runner in 'sparse_pallas' (K3/K4 counted,
    the first K3 call held as in 28), the scan runner on
    configs/efcn_event_full.yml (K1 counted, one call an example, the
    first bit-equal to its plain version), the same with --ts_window 16
    (the 'events' engine ignores the window, as in the JAX package: K1
    again, K2 not launched), the multi-stream runner with --num_streams 2
    in this process (an NCCL world of 1: K1 counted, one call on its
    stream axis a batch of 2 examples, the first bit-equal to its plain
    version) and in a process of its own started as torchrun starts a
    rank (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR=127.0.0.1: the env://
    rendezvous), and YoloFrameJax through the frame runner: each run's
    stats line.

Then the multi-device layer (async_ev_cnn_torch/parallel/), one process a
device over torch.distributed:

30. mesh: the one-card deployment, an NCCL world of 1, at full width with
    the seeded weights at 'highest': MultiStreamEngine.scan_parallel on a
    1 x 1 mesh, S=8 streams of 64 chunks, outputs and end surfaces
    bit-equal to the meshless scan_parallel on the same [S, T, E] (K1
    counted, one launch pair; its call bit-equal to its plain version);
    MultiStreamEngine.scan in 'sparse_pallas', 2 clustered streams x 8
    chunks, within 1e-4 of each stream's YoloEventTorch.scan (K3 counted,
    its first call held as in 28); TimeShardEngine on a time mesh of 1
    within 1e-4 of scan_parallel, its collectives and the NCCL all_gather
    of a plane timed; StreamingPipeline(streams=8, mesh=...) for 12
    dispatches of 64 chunks bit-equal to the meshless pipeline, events/s
    and p50 of both; Trainer(mesh) one step at batch 16 bit-equal to
    Trainer(mesh=None);
31. ranks: 4 gloo ranks on the one card (NCCL takes one rank a card):
    dryrun_multichip(4), every leg within 1e-5 of the unsharded path; the
    full-width MultiStreamEngine.scan_parallel on a 4 x 1 mesh, 2 streams
    a rank, gathered within 1e-4 of phase 30's one-process S=8 call, each
    rank's K1 counted (one call) and that call, at the rank's own
    [2, 64, ...] shapes, bit-equal to its plain version.

Then Orbax checkpoints, the ranks CLI and the window memory model:

32. orbax: with tensorstore, the seeded weights written by
    save_params_orbax and read by load_params bit-equal (both timed), and
    16 dispatches of phase 4's stream served from
    YoloEventTorch(checkpoint=orbax_dir) bit-equal to the .npz-loaded
    model's (K1 counted, its first call bit-equal to its plain version);
    without tensorstore, load_params on an Orbax directory raises the
    NotImplementedError that names it ("tensorstore absent, refused");
33. ranks CLI: run_networks --num_streams 2 --num_ranks 2 on
    configs/efcn_event_full.yml over 8 examples: with one card, refused on
    cuda before any rank starts (the error names --device cpu) and run to
    its end with --device cpu on two gloo ranks; with two cards or more,
    two NCCL ranks a card each (rank 0's stats), and the rank side again
    with K1 counted and held bit-equal to its plain version in each rank;
34. memory model: EventNetwork.scan_parallel's peak on the card
    (max_memory_allocated above the bytes before the call, with and
    without its outputs) against parallel_live_bytes_per_chunk at
    tests/test_memory_model.py's three geometries and the eFCN (T=200):
    2 * model * T covers the peak without outputs, model * T is at most
    30 times it, and auto_window(200, B) keeps the eFCN's windowed call
    within B MB at B = 256 and 1024 (grids within 1e-4, end surface
    bit-equal);
35. epilogue (run after phase 15): the conv epilogue
    (csrc/conv_epilogue.cu) at the eFCN's seven conv outputs of a served
    dispatch (N = 1,024 frames), equal to
    its plain version (torch.equal) in float32 and bf16, each layer's
    device time and their sum beside the bound (bytes), the plain
    version's time and the unfused layers' passes (the bias add, x * alpha,
    the maximum, F.max_pool2d) by device time;
36. fused conv + pool (run after phase 35): C1 (csrc/conv_pool.cu) at the
    route's seven pairs (the eFCN's conv2-conv5, YOLOv3-tiny's conv2, conv4
    and conv6) at N = 64 within its bound of its plain version
    (ops/conv_pool.c1_bound) and within 1e-6 of the largest magnitude of
    cuDNN's conv and the pooled epilogue, and at N = 1,024 frames its
    device time beside its FLOP bound, the plain version's time by events
    and cuDNN's conv and the pooled epilogue's device time; then the time
    and peak memory of the card plans' probes of both networks at N =
    1,024 (each pair's C1 against cuDNN's conv and the pooled epilogue,
    layers/conv_stack.c1_gives_the_library);
37. RVT-B (run after phase 36): async_ev_cnn_torch/configs/rvt_base_event.yml
    at 384x640 and its published widths, with reference/rvt.py's seeded
    weights.  L1 (csrc/layer_norm.cu), G1 (csrc/lstm_gates.cu) and E1's
    SiLU form within 1e-6 of their plain versions' largest values at
    every shape of a dispatch's walk (the four embeddings' channels-first
    maps over 1,024 frames; each pair's window partition, grid pre-norm and
    MLP norm at its block of frames; a step of each LSTM over 16 streams;
    each shape of the SiLU convs), each with its device time and bound
    (bytes) and the sum over a dispatch; then the rvt_base_full.replay_s16
    cell's dispatch (16 streams x 64 chunks of 200 clustered events)
    through StreamingPipeline with the counts set to 0 just before it:
    exact L1 (4 + 4 a pair a block of frames: 52), G1 (256), E1 (47 SiLU,
    9 linear), K1 (1) and recurrent-step (256) counts, its peak inside the
    memory model, and a profiled dispatch's device time by kernel; one
    stream's 64 chunks under a 2,000 MB window budget peak inside it.

It then prints the kernels' JSON line, the nvidia-smi line, and last the
result line.  K1's to K6's ``ms`` are their device time per call from
torch.profiler (K1's: the binning pass and the scan, also with a stream
axis; K3's, K4's and K5's:
the gather-GEMM kernel plus, where the plan splits the reduction, its
split pass; K6's: the kernel, its weights passed by value from host
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

import contextlib
import io
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
# calls a trace of named kernels runs ahead of the ones it counts (device_ms)
TRACE_LEAD = 4
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
# K6 where the serving path runs it: the stems of a served dispatch of
# 1,024 frames (16 streams x 64 chunks), (what, N, H, W, O)
K6_DISPATCHES = (("efcn 160x224", 1024, 160, 224, 16),
                 ("yolov3-tiny 416x416", 1024, 416, 416, 16))


def scan_launches(events: int = 0, streams: int = 0, tsmap: int = 0) -> dict:
    """The launch counts of ops/surface_scan.py that a path must show: K1
    without and with a stream axis, K2."""
    return {"surface_scan_events": events, "surface_scan_events_streams": streams,
            "surface_scan_tsmap": tsmap}


def build_native():
    """Build native/evio.cc with the host's C++ compiler into build/native/
    (what data/native.py does at first use; with OpenMP where the compiler
    has it, the library's name says which); returns the library's path and
    the seconds the build took (None: found built)."""
    from async_ev_cnn_torch.data import native

    t0 = time.perf_counter()
    found = any(native.library_path(openmp=o).exists() for o in (True, False))
    path = native.build()
    return path, None if found else time.perf_counter() - t0


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


def trace_ms(recs, keys, iters: int, lead: int, per_call: int):
    """Device ms a call from the CUDA records ``recs`` of one trace of
    ``iters + lead`` calls, or None where the trace lost records.  Each
    kernel name (each of ``keys``, matched as a part of the name; each
    name recorded when ``keys`` is None) launched ``m`` times a call
    (``per_call``; when ``keys`` is None, its count over ``iters + lead``
    rounded) must have between ``m * iters`` and ``m * (iters + lead)``
    records, and its last ``m * iters`` in start order are summed, so a
    lost record is only ever stood in for by a record of the same kernel."""
    names = keys if keys is not None else sorted({e.name for e in recs})
    if not names:
        return None
    total_us = 0.0
    for k in names:
        mine = sorted((e for e in recs if (k in e.name if keys is not None else e.name == k)),
                      key=lambda e: e.time_range.start)
        m = per_call if keys is not None else round(len(mine) / (iters + lead))
        if m < 1 or not m * iters <= len(mine) <= m * (iters + lead):
            return None
        total_us += sum(e.time_range.elapsed_us() for e in mine[-m * iters:])
    return total_us / 1e3 / iters


def device_ms(fn, kernel_keys=None, iters: int = 20, per_call: int = 1) -> float:
    """Device time per call of ``fn`` under torch.profiler: the kernels
    whose name holds one of ``kernel_keys`` (a name or a tuple of names,
    each launched ``per_call`` times a call; every kernel and copy when
    None), over ``iters`` calls.  Unlike :func:`time_ms` it leaves out the
    host's time between launches, which sets a small kernel's wall time.

    A trace runs ``TRACE_LEAD`` calls more than it counts and is read by
    :func:`trace_ms`, name by name.  Traces on the H100 lose kernel
    records (once one launch, once a whole trace, late in a long run of
    this script 1-3 records of every trace, five traces running, once
    about half of one kernel's in a trace of every kernel); a trace that
    lost more than the lead calls cover is taken again after a pause, 5
    traces at most, and then the call fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    keys = (kernel_keys,) if isinstance(kernel_keys, str) else kernel_keys
    fn()
    torch.cuda.synchronize()
    counts = []
    for attempt in range(5):
        time.sleep(0.2 * attempt)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters + TRACE_LEAD):
                fn()
            torch.cuda.synchronize()
        recs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        ms = trace_ms(recs, keys, iters, TRACE_LEAD, per_call)
        if ms is not None:
            return ms
        counts.append(len(recs))
    raise RuntimeError(f"chip_smoke check failed: profiled {counts} records of "
                       f"{keys or 'every kernel'} in 5 traces of {iters} + {TRACE_LEAD} "
                       f"calls x {per_call}")


def gg_device_ms(fn, plan) -> float:
    """Device time per call of a K3 or K5 wrapper: its gather-GEMM kernel
    and, where the plan splits the reduction, the split pass."""
    return device_ms(fn, GG_KERNELS if plan.splits > 1 else GG_KERNELS[0])


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
            "other_ms": {s: device_ms(call, GG_KERNELS if s > 1 else GG_KERNELS[0])
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
    require(dict(sc.LAUNCHES) == scan_launches(events=0, tsmap=0),
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
    want = tf.fused_stem_plain(x, taps.to(x.device), bias.to(x.device), alpha)
    torch.cuda.synchronize()
    require(bit_equal(got, again), f"K6 at {what}: two launches on the same inputs differ")
    err = float((got - want).abs().max())
    tol = tf.K6_TOL * (1 + float(want.abs().max()))
    require(err <= tol, f"K6 at {what} differs from its plain version by {err} > {tol}")
    return err


def library_stem(x, kernel, bias, alpha):
    """The library stem: cuDNN's conv and the pooled epilogue (bias, leaky
    and the 2x2 pool in one pass), the path of a pair K6 does not take."""
    from async_ev_cnn_torch.ops import conv as tconv
    from async_ev_cnn_torch.ops import epilogue as ep

    return ep.conv_epilogue(tconv.conv2d_dense(x, kernel, None, 1, "SAME"), bias, alpha,
                            pooled=True)


def stem_dispatch_times(dev) -> list:
    """K6 at K6_DISPATCHES against the library stem: within K6_TOL * (1 +
    max |library|), the device time of both and K6's bound."""
    from async_ev_cnn_torch.ops import fused_stem as tf

    rows = []
    g = torch.Generator(device=dev).manual_seed(14)
    for what, n, h, w, o in K6_DISPATCHES:
        x = torch.rand(n, h, w, generator=g, device=dev) * (
            torch.rand(n, h, w, generator=g, device=dev) < 0.2)
        kernel = torch.randn(o, 1, 3, 3, generator=g, device=dev) * 0.3
        bias = torch.randn(o, generator=g, device=dev) * 0.1
        taps, b_host = tf.w_taps_from_oihw(kernel).cpu(), bias.cpu()
        got = tf.fused_stem(x, taps, b_host, 0.1)
        lib = library_stem(x[:, None], kernel, bias, 0.1)
        torch.cuda.synchronize()
        err = float((got - lib).abs().max())
        tol = tf.K6_TOL * (1 + float(lib.abs().max()))
        require(err <= tol, f"K6 at {what} differs from the library stem by {err} > {tol}")
        del got, lib
        b_ms, b_by = bound_ms(4 * (n * h * w + n * o * (h // 2) * (w // 2)),
                              2 * 9 * n * o * h * w)
        rows.append({"what": what, "shape": [n, h, w, o], "max_abs_err": err,
                     "ms": device_ms(lambda: tf.fused_stem(x, taps, b_host, 0.1), iters=10),
                     "library_ms": device_ms(lambda: library_stem(x[:, None], kernel, bias, 0.1),
                                             iters=5),
                     "bound_ms": b_ms, "bound_by": b_by})
        del x
        torch.cuda.empty_cache()
    return rows


def stem_kernel_phase(dev, model, c0):
    """Phase 14: K6 on the T=200 surfaces of a full-width dispatch, against
    its plain version, the network's stem, the library stem and
    fused_conv_pool, then at its edge shapes (K6_EDGES) and at a served
    dispatch's stems (K6_DISPATCHES).  Returns K6's entry of the kernels'
    JSON line, less its launches, which are the main path's."""
    from async_ev_cnn_torch.ops import conv as tconv
    from async_ev_cnn_torch.ops import fused_stem as tf
    from async_ev_cnn_torch.ops import pool as tpool
    from async_ev_cnn_torch.ops import stem as tstem
    from async_ev_cnn_torch.ops.integrate import integrate_parallel

    st0 = model.init_state()
    surfaces, _ = integrate_parallel(st0[0].surface, st0[0].prev_ts, c0, LEAK)
    x = surfaces[:, 0].contiguous()                                  # [T, H, W]
    w1, b1 = model.params["w_conv1"], model.params["b_conv1"].float().contiguous()
    # the weights as the path passes them: by value, from host memory
    taps, b1_host = tf.w_taps_from_oihw(w1).cpu(), b1.cpu()
    got = tf.fused_stem(x, taps, b1_host, 0.1)
    err = k6_check(x, taps, b1_host, 0.1, "full width")
    tf.reset_launches()
    path = model.net.full_frame_forward(model.params, st0, surfaces, upto=2)
    torch.cuda.synchronize()
    require(tf.LAUNCHES["fused_stem"] == 1 and bit_equal(path, got),
            f"the network's stem launched K6 {tf.LAUNCHES['fused_stem']} times, or differs "
            "from K6's own call")
    fused = tstem.fused_conv_pool(surfaces, w1, b1, 0.1)
    lib = library_stem(surfaces, w1, b1, 0.1)
    torch.cuda.synchronize()
    err_f = float((got - fused).abs().max())
    err_d = float((got - lib).abs().max())
    require(err_f <= 1e-5 and err_d <= tf.K6_TOL * (1 + float(lib.abs().max())),
            f"K6 differs from fused_conv_pool by {err_f}, from the library stem by {err_d}")
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
            lib_e = (tstem.fused_conv_pool(xe[:, None], ke, be, alpha),
                     tpool.maxpool_dense(tconv.leaky(tconv.conv2d_dense(
                         xe[:, None], ke, be, 1, "SAME"), alpha), (2, 2), 2))
            lib_err = max(float((got_e - y).abs().max()) for y in lib_e)
            require(lib_err <= 1e-5, f"K6 at {what} differs from the library stems by {lib_err}")
        edges.append(f"{what} (T={t_e} {h_e}x{w_e} O={o_e} alpha={alpha}) {e_err:.2e}")
        err = max(err, e_err)
    t, h, w = x.shape
    o = taps.shape[1]

    def call():
        return tf.fused_stem(x, taps, b1_host, 0.1)

    times = {
        # a call's device time: the kernel alone (its weights travel as
        # launch parameters)
        "ms": device_ms(call),
        "kernel_ms": device_ms(call, "fused_stem_kernel"),
        "call_ms": time_ms(call, 50),
        "plain_ms": time_ms(lambda: tf.fused_stem_plain(x, taps.to(dev), b1, 0.1), 3),
        "library_ms": device_ms(lambda: library_stem(surfaces, w1, b1, 0.1)),
        "fused_conv_pool_ms": device_ms(lambda: tstem.fused_conv_pool(surfaces, w1, b1, 0.1)),
    }
    b_ms, b_by = bound_ms(4 * (t * h * w + 10 * o + t * o * (h // 2) * (w // 2)),
                          2 * 9 * t * o * h * w)
    dispatches = stem_dispatch_times(dev)
    print(f"stem-kernel: K6 over the {t} surfaces of a dispatch (C=1 {h}x{w}, O={o}): "
          f"within {tf.K6_TOL} * (1 + max|plain|) of its plain version, bit-equal across two "
          f"launches and to the network's stem (max abs err {err:.2e} over the dispatch and "
          "the edges: " + "; ".join(edges) + f"), within {err_f:.2e} of fused_conv_pool and "
          f"{err_d:.2e} of the library stem (cuDNN's conv and the pooled epilogue; the edges "
          "with alpha <= 1 within 1e-5 of both library stems); "
          f"K6 device {times['ms']:.4f} ms a call (kernel {times['kernel_ms']:.4f}, a call by "
          f"events {times['call_ms']:.4f}; plain {times['plain_ms']:.3f}, library stem device "
          f"{times['library_ms']:.4f}, fused_conv_pool device "
          f"{times['fused_conv_pool_ms']:.4f}, bound {b_ms:.5f} {b_by}); a served dispatch's "
          "stems (device ms: K6, library, K6's bound): " + "; ".join(
              f"{r['what']} N={r['shape'][0]} {r['ms']:.4f}, {r['library_ms']:.4f}, "
              f"{r['bound_ms']:.4f} {r['bound_by']} (err {r['max_abs_err']:.2e})"
              for r in dispatches), flush=True)
    return {"name": "fused_stem", "route": "cuda",
            "source": "async_ev_cnn_torch/csrc/fused_stem.cu",
            "replaces": "examples/pallas_stem_negative.py:74",
            "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by, **times,
            "dispatches": dispatches}


# the eFCN's conv outputs in one served dispatch of the benchmark's replay
# cell (16 streams x 64 chunks = 1,024 frames): (name, C, H, W, pooled)
EPILOGUE_N = 1024
# a forward of the eFCN on the card at T_CHUNKS frames: K6 once, C1 on
# conv2 -> pool2, conv4 -> pool4 and conv5 -> pool5, and the epilogue after
# conv3 (cuDNN runs it as an FFT at that batch, whose numbers C1 does not
# give, so the card's plan keeps it on the 'pooled' route), conv6 and conv7
EPILOGUES = 3
C1S = 3
STEMS = 1
EPILOGUE_LAYERS = (
    ("conv1", 16, 160, 224, True), ("conv2", 32, 80, 112, True),
    ("conv3", 64, 40, 56, True), ("conv4", 128, 20, 28, True),
    ("conv5", 256, 10, 14, True), ("conv6", 512, 5, 7, False),
    ("conv7", 110, 5, 7, False),
)


def epilogue_phase(dev, smi):
    """Phase 35: the conv epilogue kernel (csrc/conv_epilogue.cu) at the
    eFCN's seven conv outputs of a served dispatch (N = EPILOGUE_N), each
    equal to its plain version (torch.equal) in float32 and bf16; its device
    time beside its bound (bytes: the raw output read once, the result
    written once), the plain version's time by CUDA events and, as the
    yardstick, the device time of the unfused layers' passes (the bias
    add, x * alpha, the maximum and F.max_pool2d), a layer and summed.
    Returns the kernel's entry of the kernels' JSON line, less its
    launches, which are the main path's."""
    from async_ev_cnn_torch.ops import epilogue as ep

    g = torch.Generator(device=dev).manual_seed(35)
    rows, launches, err = [], 0, 0.0
    for name, c, h, w, pooled in EPILOGUE_LAYERS:
        raw = torch.randn(EPILOGUE_N, c, h, w, generator=g, device=dev)
        bias = torch.randn(c, generator=g, device=dev) * 0.3
        for act in ("float32", "bfloat16"):
            before = ep.LAUNCHES["conv_epilogue"]
            got = ep.conv_epilogue(raw, bias, 0.1, act, pooled=pooled)
            launches += ep.LAUNCHES["conv_epilogue"] - before
            want = ep.conv_epilogue_plain(raw.clone(), bias, 0.1, act, pooled=pooled)
            torch.cuda.synchronize()
            require(got.dtype == want.dtype and torch.equal(got, want),
                    f"the conv epilogue at {name} ({act}) differs from its plain version")
            err = max(err, float((got.float() - want.float()).abs().max()))
            del got, want
        out_px = (h // 2) * (w // 2) if pooled else h * w
        b_ms, _ = bound_ms(4 * raw.numel() + 4 * EPILOGUE_N * c * out_px, 0)
        scratch = raw.clone()  # the plain version adds the bias in place

        def kernel(raw=raw, bias=bias, pooled=pooled):
            return ep.conv_epilogue(raw, bias, 0.1, pooled=pooled)

        def plain(bias=bias, pooled=pooled, scratch=scratch):
            return ep.conv_epilogue_plain(scratch, bias, 0.1, pooled=pooled)

        rows.append({"layer": name, "shape": [EPILOGUE_N, c, h, w], "pooled": pooled,
                     "ms": device_ms(kernel, "epilogue_kernel"), "bound_ms": b_ms,
                     "plain_ms": time_ms(plain, 5), "library_ms": device_ms(plain)})
        del raw, scratch
        torch.cuda.empty_cache()
    total = {k: sum(r[k] for r in rows) for k in ("ms", "bound_ms", "plain_ms", "library_ms")}
    print(f"epilogue: the conv epilogue equal to its plain version (torch.equal) at the "
          f"eFCN's seven conv outputs, N={EPILOGUE_N}, float32 and bf16 ({launches} launches); "
          "device ms a call (bound, share of it; plain by events; the unfused passes' "
          "device time): " + "; ".join(
              f"{r['layer']} {r['ms']:.4f} ({r['bound_ms']:.4f}, "
              f"{100 * r['bound_ms'] / r['ms']:.1f}%; {r['plain_ms']:.4f}; "
              f"{r['library_ms']:.4f})" for r in rows)
          + f"; sum {total['ms']:.4f} ms (bound {total['bound_ms']:.4f}, "
          f"{100 * total['bound_ms'] / total['ms']:.1f}%; plain {total['plain_ms']:.4f}; "
          f"unfused passes {total['library_ms']:.4f}); card {smi!r}", flush=True)
    return {"name": "conv_epilogue", "route": "cuda",
            "source": "async_ev_cnn_torch/csrc/conv_epilogue.cu", "replaces": None,
            "max_abs_err": err, "bound_by": "bytes", **total,
            "layers": rows}


C1_N = 1024
C1_CHECK_N = 64
# the networks whose card plans probe C1 at C1_N frames: (name, config,
# H, W); the eFCN's config holds its DSL, YOLOv3-tiny's its line
C1_NETS = (("efcn", "configs/efcn_event_full.yml", 160, 224),
           ("yolov3-tiny", "async_ev_cnn_torch/configs/yolov3_tiny_event.yml", 416, 416))
C1_PAIRS = (("efcn conv2", 16, 32, 80, 112), ("efcn conv3", 32, 64, 40, 56),
            ("efcn conv4", 64, 128, 20, 28), ("efcn conv5", 128, 256, 10, 14),
            ("yolov3-tiny conv2", 16, 32, 208, 208), ("yolov3-tiny conv4", 32, 64, 104, 104),
            ("yolov3-tiny conv6", 64, 128, 52, 52))


def conv_pool_phase(dev, smi):
    """Phase 36: the fused conv + pool C1 at the route's seven pairs: at N =
    C1_CHECK_N within its bound of its plain version and within LIBRARY_REL
    of the largest magnitude of cuDNN's conv and the pooled epilogue; at N =
    C1_N its device time beside its FLOP bound (FP32 at PEAK_F32_S), the
    plain version's time by events and the library pair's device time (the
    conv and the epilogue it replaced); then the card plans' probes
    (c1_probe_costs).  Returns C1's entry of the kernels'
    JSON line, less its launches, which are the main path's."""
    from async_ev_cnn_torch.ops import conv_pool as cp
    from async_ev_cnn_torch.ops import epilogue as ep
    from async_ev_cnn_torch.ops.conv import conv2d_dense

    g = torch.Generator(device=dev).manual_seed(36)
    rows, err = [], 0.0
    for what, c_in, c_out, h, w in C1_PAIRS:
        def operands(n):
            x = torch.rand(n, c_in, h, w, generator=g, device=dev) * (
                torch.rand(n, c_in, h, w, generator=g, device=dev) < 0.5)
            k = torch.randn(c_out, c_in, 3, 3, generator=g, device=dev) * (2 / (9 * c_in)) ** 0.5
            return x, k, torch.randn(c_out, generator=g, device=dev) * 0.1

        def library(x, k, b):
            return ep.conv_epilogue(conv2d_dense(x, k, None, 1, "SAME"), b, 0.1, pooled=True)

        x, k, b = operands(C1_CHECK_N)
        got = cp.conv_pool(x, k, b, 0.1)
        plain = cp.conv_pool_plain(x, k, b, 0.1)
        lib = library(x, k, b)
        torch.cuda.synchronize()
        gap = (got.double() - plain.double()).abs()
        require(bool((gap <= cp.c1_bound(x, k, b, plain)).all()),
                f"C1 at {what} leaves its bound of the plain version")
        rel = float((got - lib).abs().max() / lib.abs().max())
        require(rel <= cp.LIBRARY_REL,
                f"C1 at {what} is {rel} of the library pair's largest value")
        err = max(err, float(gap.max()))
        del x, got, plain, lib
        x, k, b = operands(C1_N)
        packed = cp.pack_weights(k, b)
        b_ms, b_by = bound_ms(4 * (x.numel() + C1_N * c_out * (h // 2) * (w // 2)),
                              2 * 9 * c_in * c_out * h * w * C1_N)
        rows.append({"pair": what, "shape": [C1_N, c_in, c_out, h, w], "rel_to_library": rel,
                     "ms": device_ms(lambda: cp.conv_pool(x, k, b, 0.1, packed),
                                     "conv_pool_kernel", iters=10),
                     "plain_ms": time_ms(lambda: cp.conv_pool_plain(x, k, b, 0.1), 1, 2),
                     "library_ms": device_ms(lambda: library(x, k, b), iters=10),
                     "bound_ms": b_ms, "bound_by": b_by})
        del x
        torch.cuda.empty_cache()
    probes = c1_probe_costs(dev)
    print(f"conv_pool: C1 within its bound of its plain version and within "
          f"{cp.LIBRARY_REL} of the library pair at the route's seven pairs (N={C1_CHECK_N}); N={C1_N} device ms "
          "(bound, share of it; plain by events; cuDNN's conv and the pooled epilogue): "
          + "; ".join(f"{r['pair']} {r['ms']:.4f} ({r['bound_ms']:.4f}, "
                      f"{100 * r['bound_ms'] / r['ms']:.1f}%; {r['plain_ms']:.1f}; "
                      f"{r['library_ms']:.4f})" for r in rows)
          + "; the card plan's probes at N=" + str(C1_N) + " (C1 pairs, s, peak bytes above the "
          "allocated): " + "; ".join(f"{r['net']} {'/'.join(r['c1'])} {r['probe_s']:.3f} "
                                     f"{r['probe_peak_bytes']}" for r in probes)
          + f"; card {smi!r}", flush=True)
    return {"name": "conv_pool", "route": "cuda", "source": "async_ev_cnn_torch/csrc/conv_pool.cu",
            "replaces": None, "max_abs_err": err, "bound_by": "operations", "pairs": rows,
            "probes": probes}


def c1_probe_costs(dev) -> list:
    """The card plan of each of C1_NETS for a batch of C1_N frames, made on
    a fresh network: the pairs it gives C1, the seconds its probes take
    (cuDNN's first call at each shape included) and their peak memory
    above what was allocated before."""
    from async_ev_cnn_torch.layers import conv_stack
    from async_ev_cnn_torch.layers.network import EventNetwork
    from async_ev_cnn_torch.utils.config import layers_dict

    rows = []
    for what, path, h, w in C1_NETS:
        dsl = Path(path).read_text().split("yolo_cnn_layers: ")[1].split("\n")[0]
        net = EventNetwork(layers_dict(dsl), h, w, 5e-5, 0.1, "SAME", conv_mode="full",
                           stem_fusion=False)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        steps = conv_stack.plan(net, dev, False, frames=C1_N)
        torch.cuda.synchronize()
        rows.append({"net": what, "frames": C1_N, "probe_s": time.perf_counter() - t0,
                     "probe_peak_bytes": torch.cuda.max_memory_allocated() - base,
                     "c1": [s.layers[0].name for s in steps if s.route == "conv_pool"]})
        del net, steps
        torch.cuda.empty_cache()
    return rows


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


def yolo_kwargs(args, layer_defs, num_classes, num_bbox, dev, **kw):
    """The eFCN model arguments of the config, on ``dev``."""
    return dict(h_frame=args.frame_h, w_frame=args.frame_w, num_classes=num_classes,
                cnn_layers=layer_defs, cnn_padding=args.yolo_cnn_padding,
                h_cells=args.yolo_num_cells_h, w_cells=args.yolo_num_cells_w,
                num_bbox=num_bbox, alpha=0.1, leak=args.leak, device=dev, **kw)


def checkpoint_phase(model, kwargs, items, smi):
    """Phase 18: the seeded weights written as .npz and as a TF bundle,
    loaded back by ``YoloEventTorch(checkpoint=...)``; a dispatch of each
    through ``scan`` (K1) against the ``set_weights`` model; the stream
    state saved after one dispatch and restored for the next."""
    import tempfile

    from async_ev_cnn_torch.models.yolo import YoloEventTorch
    from async_ev_cnn_torch.ops import surface_scan as sc
    from async_ev_cnn_torch.utils.checkpoint import (
        restore_stream_state, save_params, save_params_tf, save_stream_state)
    from async_ev_cnn_torch.utils.runner import pack_chunks

    dev = model.device
    weights = make_params(kwargs["cnn_layers"], np.random.RandomState(0))
    c0 = pack_chunks(items[0], CAPACITY, device=dev)
    c1 = pack_chunks(items[1], CAPACITY, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {"npz": str(Path(tmp) / "efcn.npz"), "bundle": str(Path(tmp) / "efcn")}
        t0 = time.perf_counter()
        save_params(paths["npz"], weights)
        save_s = {"npz": time.perf_counter() - t0}
        t0 = time.perf_counter()
        save_params_tf(paths["bundle"], weights)
        save_s["bundle"] = time.perf_counter() - t0
        loaded, load_ms = {}, {}
        for fmt, path in paths.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loaded[fmt] = YoloEventTorch(**kwargs, conv_mode="full", checkpoint=path)
            torch.cuda.synchronize()
            load_ms[fmt] = (time.perf_counter() - t0) * 1e3
        n_bytes = sum(v.nbytes for v in weights.values())
        for fmt, m in loaded.items():
            require(sorted(m.params) == sorted(model.params)
                    and all(m.params[k].dtype == v.dtype and bit_equal(m.params[k], v)
                            for k, v in model.params.items()),
                    f"the {fmt} checkpoint's parameters differ from set_weights'")
        # the path: one T=200 dispatch of each model through scan (K1)
        sc.reset_launches()
        grids = {name: m.scan(m.init_state(), c0)
                 for name, m in (("set_weights", model), *loaded.items())}
        torch.cuda.synchronize()
        launches = dict(sc.LAUNCHES)
        require(launches == scan_launches(events=3, tsmap=0),
                f"checkpoint path launches {launches} for three single-window dispatches")
        ref_state, ref = grids["set_weights"]
        for fmt in loaded:
            require(bit_equal(grids[fmt][1], ref)
                    and bit_equal(grids[fmt][0][0].surface, ref_state[0].surface),
                    f"the {fmt} model's dispatch differs from the set_weights model's")
        # the stream state across a save and a restore
        state_path = str(Path(tmp) / "state.npz")
        t0 = time.perf_counter()
        save_stream_state(state_path, ref_state)
        restored = restore_stream_state(state_path, model.init_state())
        state_ms = (time.perf_counter() - t0) * 1e3
        st_a, out_a = model.scan(ref_state, c1)
        st_b, out_b = model.scan(restored, c1)
        torch.cuda.synchronize()
        require(bit_equal(out_a, out_b) and bit_equal(st_a[0].surface, st_b[0].surface)
                and int(st_a[0].prev_ts) == int(st_b[0].prev_ts),
                "the dispatch after a restored stream state differs from the uninterrupted run")
    print(f"checkpoint: seeded eFCN weights ({n_bytes} bytes) written as .npz in "
          f"{save_s['npz'] * 1e3:.1f} ms and as a TF bundle in {save_s['bundle'] * 1e3:.1f} ms; "
          f"YoloEventTorch(checkpoint=...) built and loaded in {load_ms['npz']:.1f} ms (npz), "
          f"{load_ms['bundle']:.1f} ms (bundle), parameters bit-equal to set_weights'; one "
          f"T={T_CHUNKS} dispatch of each through scan bit-equal (launches {launches}); the "
          f"stream state saved and restored in {state_ms:.1f} ms, the next dispatch bit-equal "
          f"to the uninterrupted run; card {smi!r}", flush=True)
    return load_ms


def frame_phase(model, kwargs, items, smi):
    """Phase 19: the frame detector.  ``integrate_frame`` chained per chunk
    on the card over one dispatch's events; ``YoloFrameTorch`` on every
    frame against the event model's grids at the same chunk boundaries and
    against itself on the CPU; the dense 'numpy' chain against
    ``YoloFrameNumpy``; then decode, ``nms_torch`` against the host ``nms``,
    and ``evaluate_detections``."""
    from async_ev_cnn_torch.layers.network import dense_forward
    from async_ev_cnn_torch.models import head
    from async_ev_cnn_torch.models.yolo import YoloFrameNumpy, YoloFrameTorch
    from async_ev_cnn_torch.ops import integrate as it
    from async_ev_cnn_torch.utils.evaluation import decode_predictions, evaluate_detections
    from async_ev_cnn_torch.utils.nms import nms, nms_torch
    from async_ev_cnn_torch.utils.runner import pack_chunks

    dev = model.device
    weights = make_params(kwargs["cnn_layers"], np.random.RandomState(0))
    events = torch.from_numpy(items[0]).to(dev)
    state, frames = None, []
    for i in range(T_CHUNKS):
        state = it.integrate_frame(events[i * CAPACITY:(i + 1) * CAPACITY], LEAK, H, W,
                                   state, device=dev)
        frames.append(state[0])
    frames = torch.stack(frames)
    c0 = pack_chunks(items[0], CAPACITY, device=dev)
    zero = torch.zeros((1, H, W), dtype=torch.float32, device=dev)
    surfaces, _ = it.integrate_parallel(zero, 0, c0, LEAK)
    require(bit_equal(frames, surfaces[:, 0]),
            "integrate_frame chained per chunk != the event path's surfaces")
    _, grids = model.scan(model.init_state(), c0)

    fm = YoloFrameTorch(**kwargs)
    fm.set_weights(weights)
    outs, ends = [], []
    fm.forward(frames[0])  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for t in range(T_CHUNKS):
        outs.append(fm.forward(frames[t]))
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    marks = [start.elapsed_time(e) for e in ends]
    per_frame = np.diff([0.0] + marks)
    outs = torch.stack(outs)
    ev_err = float((outs - grids).abs().max())
    require(ev_err <= OUT_TOL, f"YoloFrameTorch differs from the event grids by {ev_err}")
    few = (0, T_CHUNKS // 2, T_CHUNKS - 1)
    fm_cpu = YoloFrameTorch(**{**kwargs, "device": "cpu"})
    fm_cpu.set_weights(weights)
    cpu_err = max(float((fm_cpu.forward(frames[t].cpu()) - outs[t].cpu()).abs().max())
                  for t in few)
    require(cpu_err <= OUT_TOL, f"YoloFrameTorch on the card and the CPU differ by {cpu_err}")
    fn = YoloFrameNumpy(**{k: v for k, v in kwargs.items() if k != "device"})
    fn.set_weights(weights)
    numpy_err = 0.0
    for t in few[:2]:
        chain = dense_forward(fm.net.event_layers, fm.params, frames[t], "numpy", alpha=0.1)
        want = next(reversed(chain.values())).permute(1, 2, 0).reshape(fm.grid_shape)
        numpy_err = max(numpy_err, float(np.abs(fn.forward(frames[t].cpu().numpy())
                                                 - want.cpu().numpy()).max()))
    require(numpy_err <= OUT_TOL, f"YoloFrameNumpy differs from the 'numpy' chain by {numpy_err}")

    # post-processing: decode, NMS on the card against the host, mAP
    num_classes, num_bbox = kwargs["num_classes"], kwargs["num_bbox"]
    boxes, scores, probs = head.decode(outs, num_classes, num_bbox, H, W)
    thr = float(torch.quantile(scores.flatten().float(), 0.9))
    kept = 0
    for t in few:
        valid = scores[t] > thr
        keep = nms_torch(boxes[t], scores[t], valid, 0.5)
        host = nms(boxes[t].cpu().numpy(), scores[t].cpu().numpy(), valid.cpu().numpy(), 0.5)
        require(np.array_equal(np.where(keep.cpu().numpy())[0], np.sort(host)),
                f"nms_torch on the card keeps other boxes than nms on the host (frame {t})")
        kept += len(host)
    pthr = float(torch.quantile(probs.flatten().float(), 0.99))
    preds = [decode_predictions(outs[t], num_classes, num_bbox, H, W, conf_threshold=pthr)
             for t in few]
    host_preds = [decode_predictions(outs[t].cpu().numpy(), num_classes, num_bbox, H, W,
                                     conf_threshold=pthr) for t in few]
    # the boxes come from divisions by scalars, which the card's kernels
    # may round otherwise than the host's in the last bit; scores and
    # classes are products and selections, the same on both
    box_err = max((float(np.abs(p[0] - q[0]).max()) if len(p[0]) else 0.0)
                  for p, q in zip(preds, host_preds))
    require(all(p[0].shape == q[0].shape and np.array_equal(p[1], q[1])
                and np.array_equal(p[2], q[2]) for p, q in zip(preds, host_preds))
            and box_err <= 1e-3,
            "decode_predictions of the card's grids differs from the same grids on the host")
    # synthetic ground truth: three seeded boxes of 10-60 pixels a frame
    grng = np.random.RandomState(7)
    gts = [(np.concatenate([grng.rand(3, 2) * (W, H), grng.rand(3, 2) * 50 + 10],
                           1).astype(np.float32), grng.randint(0, num_classes, 3))
           for _ in few]
    result = evaluate_detections(preds, gts, num_classes)
    n_det = sum(len(p[0]) for p in preds)
    require(n_det > 0 and 0.0 <= result["mAP"] <= 1.0
            and sum(result["num_gt_per_class"]) == 3 * len(few),
            f"evaluate_detections gave {result} over {n_det} detections")
    print(f"frame: integrate_frame chained over the {T_CHUNKS} chunks of a dispatch on the card, "
          f"bit-equal to the event path's surfaces; YoloFrameTorch at 'highest' on all "
          f"{T_CHUNKS} frames within {ev_err:.3e} of YoloEventTorch's 'full' grids and within "
          f"{cpu_err:.3e} of itself on the CPU ({len(few)} frames); YoloFrameNumpy within "
          f"{numpy_err:.3e} of the dense 'numpy' chain (2 frames); "
          f"{T_CHUNKS / wall:.1f} frames/s, p50 {float(np.median(per_frame)):.3f} ms a frame "
          f"(CUDA events, one frame a call); nms_torch == nms on {len(few)} frames "
          f"({kept} boxes kept); decode_predictions on the card equal to the host's (boxes within "
          f"{box_err:.2e} px); mAP "
          f"{result['mAP']:.4f} of {n_det} detections against {3 * len(few)} synthetic "
          f"boxes (random weights); card {smi!r}", flush=True)
    return {"frames_per_s": T_CHUNKS / wall, "p50_ms": float(np.median(per_frame))}


def windowed_stream(rng, steps, events_per_step, win, rate_us=15):
    """Each chunk's events inside one random ``win`` x ``win`` box."""
    n = steps * events_per_step
    ts = np.cumsum(rng.randint(1, rate_us, size=n)).astype(np.int32)
    oy = np.repeat(rng.randint(0, H - win + 1, steps), events_per_step)
    ox = np.repeat(rng.randint(0, W - win + 1, steps), events_per_step)
    y = (oy + rng.randint(0, win, n)).astype(np.int32)
    x = (ox + rng.randint(0, win, n)).astype(np.int32)
    return np.stack([y, x, ts], axis=-1)


def fitting_chunks(events, win) -> int:
    """Chunks whose events fit a ``win`` x ``win`` box (the JAX package's
    test of its windowed ts maps)."""
    ch = events.reshape(-1, CAPACITY, 3)
    span = ch[:, :, :2].max(axis=1) - ch[:, :, :2].min(axis=1)
    return int(((span[:, 0] < win) & (span[:, 1] < win)).sum())


def ts_window_phase(model, smi):
    """Phase 20: ``scan_parallel(ts_window=(16, 16),
    integrate_engine='tsmap')`` (K2) on a clustered stream, on a dispatch
    whose chunks all fit the window and on one where a chunk overflows it,
    each against the 'events' engine (K1)."""
    from async_ev_cnn_torch.ops import surface_scan as sc
    from async_ev_cnn_torch.utils.runner import pack_chunks

    win = 16
    fit = windowed_stream(np.random.RandomState(6), T_CHUNKS, CAPACITY, win)
    over = fit.copy()
    over[7 * CAPACITY, :2] = (0, 0)  # chunk 7 spans the frame
    over[7 * CAPACITY + 1, :2] = (H - 1, W - 1)
    cases = {"clustered r=8": clustered_stream(np.random.RandomState(5), T_CHUNKS, CAPACITY),
             "all fit": fit, "one overflows": over}
    st0 = model.init_state()
    parts = []
    for name, events in cases.items():
        chunks = pack_chunks(events, CAPACITY, device=model.device)
        sc.reset_launches()
        st_w, out_w = model.net.scan_parallel(model.params, st0, chunks, ts_window=(win, win),
                                              integrate_engine="tsmap")
        torch.cuda.synchronize()
        launches = dict(sc.LAUNCHES)
        require(launches == scan_launches(events=0, tsmap=1),
                f"ts_window path ({name}) launches {launches}")
        st_e, out_e = model.net.scan_parallel(model.params, st0, chunks)
        require(bit_equal(st_w[0].surface, st_e[0].surface)
                and float((out_w - out_e).abs().max()) <= OUT_TOL,
                f"ts_window ({name}) differs from the 'events' engine")
        parts.append(f"{name} ({fitting_chunks(events, win)} of {T_CHUNKS} chunks fit): "
                     f"launches {launches}")
    print(f"ts-window: scan_parallel(ts_window=({win}, {win}), integrate_engine='tsmap') "
          "surfaces bit-equal and outputs within "
          f"{OUT_TOL} of the 'events' engine's: " + "; ".join(parts) + f"; card {smi!r}",
          flush=True)


def maxplus_phase(model, c0, k1_info, smi):
    """Phase 21: the full-width T=200 dispatch through the 'maxplus' engine
    against 'events', with the device time of both integrate calls."""
    from async_ev_cnn_torch.ops import integrate as it

    dev = model.device
    s0 = torch.from_numpy(
        (np.round(np.random.RandomState(0).rand(1, H, W) * 2**20) / 2**20).astype(
            np.float32)).to(dev)
    mp, lt_m = it.integrate_parallel(s0, 0, c0, LEAK, engine="maxplus")
    ev, lt_e = it.integrate_parallel(s0, 0, c0, LEAK, engine="events")
    err = float((mp - ev).abs().max())
    require(err <= 1e-6 and torch.equal(lt_m, lt_e),
            f"'maxplus' differs from 'events' by {err} at full width")
    st0 = model.init_state()
    st_m, out_m = model.net.scan_parallel(model.params, st0, c0, integrate_engine="maxplus")
    st_e, out_e = model.net.scan_parallel(model.params, st0, c0)
    out_err = float((out_m - out_e).abs().max())
    require(out_err <= OUT_TOL, f"'maxplus' dispatch outputs differ by {out_err}")
    mp_ms = device_ms(lambda: it.integrate_parallel(s0, 0, c0, LEAK, engine="maxplus"))
    ev_ms = device_ms(lambda: it.integrate_parallel(s0, 0, c0, LEAK, engine="events"))
    print(f"maxplus: integrate_parallel(engine='maxplus') at C=1 {H}x{W} T={T_CHUNKS} within "
          f"{err:.3e} of 'events' (surfaces), the dispatch's outputs within {out_err:.3e}; "
          f"device time of a call {mp_ms:.4f} ms against the 'events' engine's {ev_ms:.4f} ms "
          f"(K1 {k1_info['ms']:.4f} ms + the winner dedup {k1_info['front_ms']:.4f} ms in "
          f"phase 3); card {smi!r}", flush=True)
    return {"maxplus_ms": mp_ms, "events_ms": ev_ms}


# ---- the serving deployment: wire tiers, K1 on a stream axis, multi-stream
# serving, the serve CLI and the data plane (phases 22-26) --------------------

WIRE_TIER_NAMES = ("ultra4", "ultra", "compact", "plain")
K1_STREAMS = 8
SERVE_STREAMS = (1, 8, 16)
SERVE_CHUNKS = 64
SERVE_DISPATCHES = 12
CLI_STREAMS = 4
CLI_EXAMPLES = 8
CLI_EVENTS = 20_000


def tier_stream(rng, tier, n, polarity=False):
    """``n`` uniform events at full width whose timestamps fit ``tier`` and
    no smaller one: within-chunk gaps below 16 µs (ultra4); 16 to 255 µs
    (ultra); below 200 µs with one of 300 µs every 64 events, chunk spans
    under 2**16 µs (compact); the same with one of 70,000 µs instead, chunk
    spans past 2**16 µs (plain)."""
    lo, hi = {"ultra4": (1, 16), "ultra": (16, 256)}.get(tier, (1, 200))
    gaps = rng.randint(lo, hi, size=n)
    if tier in ("compact", "plain"):
        gaps[5::64] = 300 if tier == "compact" else 70_000
    cols = [rng.randint(0, H, n), rng.randint(0, W, n), np.cumsum(gaps)]
    if polarity:
        cols.append(rng.randint(0, 2, n))
    return np.stack(cols, axis=-1).astype(np.int64)


def wire_phase(dev, smi):
    """Phase 22: a T=200 stream fitting each tier, with and without
    polarity: the 'auto' ladder (ultra4 -> ultra -> compact -> plain)
    settles on that tier; the planes uploaded from pinned memory and
    decoded on the card are equal to the CPU decode field by field; bytes
    an event on the wire, the upload's and the decode's time."""
    from async_ev_cnn_torch.utils import wire as tw

    ladder = (tw.pack_wire_ultra4, tw.pack_wire_ultra, tw.pack_wire_compact, tw.pack_wire)
    staging = tw.PinnedStaging()  # the pipeline's way to the card
    rng = np.random.RandomState(22)
    n = T_CHUNKS * CAPACITY
    rows, info = [], {}
    for polarity in (False, True):
        for tier in WIRE_TIER_NAMES:
            ev = tier_stream(rng, tier, n, polarity)
            w = next(x for x in (f(ev, CAPACITY, keep_polarity=polarity) for f in ladder)
                     if x is not None)
            require(tw.wire_format(w) == tier,
                    f"the 'auto' ladder put a {tier} stream on {tw.wire_format(w)}")
            planes = tw.wire_to_device(w, dev, staging)
            got = tw.chunks_from_wire_any(planes, polarity)
            want = tw.chunks_from_wire_any(tw.wire_to_device(w, "cpu"), polarity)
            torch.cuda.synchronize()
            for f in ("y", "x", "ts", "p", "valid"):
                a, b = getattr(got, f), getattr(want, f)
                require(a.device == dev and a.dtype == b.dtype and torch.equal(a.cpu(), b),
                        f"{tier} (polarity {polarity}): the card's {f} != the CPU decode's")
            b_ev = sum(a.nbytes for a in w) / n
            decode_ms = device_ms(lambda: tw.chunks_from_wire_any(planes, polarity))
            upload_ms = time_ms(lambda: tw.wire_to_device(w, dev, staging), 20)
            info[(tier, polarity)] = {"bytes_per_event": b_ev, "decode_ms": decode_ms,
                                      "upload_ms": upload_ms}
            rows.append(f"{tier}{' +p' if polarity else ''} {b_ev:.4f} B/event, upload "
                        f"{upload_ms:.4f} ms, decode device {decode_ms:.4f} ms")
    print(f"wire: T={T_CHUNKS} x {CAPACITY} events at {H}x{W}, each stream on the tier "
          "'auto' picks, card decode == CPU decode on every field: " + "; ".join(rows)
          + f"; card {smi!r}", flush=True)
    return info


def k1_streams_phase(dev, smi, s=K1_STREAMS):
    """Phase 23: K1 with a stream axis, S streams of T=200 chunks of 256
    winners at full width: bit-equal to its plain version and to S
    one-stream calls; one call is one binning and one scan launch (the
    profiler counts them); its device time against the S one-stream calls'
    and its bytes bound."""
    from async_ev_cnn_torch.layers.types import EventChunk
    from async_ev_cnn_torch.ops import integrate as it
    from async_ev_cnn_torch.ops import surface_scan as sc
    from async_ev_cnn_torch.utils.runner import pack_chunks

    rng = np.random.RandomState(23)
    parts = [pack_chunks(synth_stream(rng, T_CHUNKS, CAPACITY), CAPACITY, device=dev)
             for _ in range(s)]
    chunks = EventChunk(*(torch.stack(f) for f in zip(*parts)))
    s0 = torch.from_numpy(
        (np.round(rng.rand(s, 1, H, W) * 2**20) / 2**20).astype(np.float32)).to(dev)
    prev = torch.from_numpy(rng.randint(0, 50, s).astype(np.int32)).to(dev)
    pix, dt, d, _ = it.chunk_event_updates(1, H, W, prev, chunks, LEAK)

    def batched():
        return sc.surface_scan_events(s0, pix, dt, d, LEAK)

    def singles():
        return [sc.surface_scan_events(s0[i], pix[i], dt[i], d[i], LEAK) for i in range(s)]

    sc.reset_launches()
    out = batched()
    torch.cuda.synchronize()
    launches = dict(sc.LAUNCHES)
    require(launches == scan_launches(streams=1), f"one stream-axis K1 call launched {launches}")
    ms = device_ms(batched, K1_KERNELS, iters=10)
    singles_ms = device_ms(singles, K1_KERNELS, iters=10, per_call=s)
    plain = sc.surface_scan_events_plain(s0, pix, dt, d, LEAK)
    one_by_one = torch.stack(singles())
    torch.cuda.synchronize()
    require(out.shape == (s, T_CHUNKS, 1, H, W), f"K1 stream axis shape {tuple(out.shape)}")
    require(bit_equal(out, plain), "K1 with a stream axis != its plain version")
    require(bit_equal(out, one_by_one), f"K1 with a stream axis != {s} one-stream calls")
    err = float((out - plain).abs().max())
    t_len, e_len, p_len = T_CHUNKS, CAPACITY, H * W
    plan = sc.scan_events_plan(t_len, e_len, p_len, s)
    info = {
        "streams": s,
        # the profiler's count proves one binning and one scan launch a call
        "ms": ms, "singles_ms": singles_ms,
        "call_ms": time_ms(batched, 50),
        "singles_call_ms": time_ms(singles, 20),
        "plain_ms": time_ms(lambda: sc.surface_scan_events_plain(s0, pix, dt, d, LEAK), 1, 3),
        "max_abs_err": err,
        "bound": bound_ms(4 * s * (t_len * p_len + p_len + 2 * t_len * e_len + t_len),
                          s * (4 * t_len * p_len + 6 * t_len * e_len)),
    }
    del out, plain, one_by_one
    print(f"k1-streams: S={s} streams x T={t_len} x E={e_len} at {H}x{W} [grid {plan.n_tiles} "
          f"tiles x {s} streams, workspace {plan.workspace} int32]: bit-equal to its plain "
          f"version and to {s} one-stream calls; launches {launches}; device "
          f"{info['ms']:.4f} ms a call (one binning + one scan launch) against "
          f"{info['singles_ms']:.4f} ms for {s} one-stream calls; a call {info['call_ms']:.4f} "
          f"ms against {info['singles_call_ms']:.4f} ms; plain {info['plain_ms']:.2f} ms; bound "
          f"{info['bound'][0]:.4f} ms {info['bound'][1]} ({100 * info['bound'][0] / info['ms']:.0f}% "
          f"of it); card {smi!r}", flush=True)
    return info


@contextlib.contextmanager
def eager_dispatches():
    """Every StreamingPipeline dispatch made inside runs eagerly
    (``serving.graph_dispatch`` refuses it): the launches that a replay
    of a captured graph stands in for, each counted by its wrapper."""
    from async_ev_cnn_torch.utils import serving

    real = serving.graph_dispatch
    serving.graph_dispatch = lambda *args: False
    try:
        yield
    finally:
        serving.graph_dispatch = real


#: each launch counter's kernels on the main path, by a part of their names
#: (K1 a binning and a scan kernel; E1 the pooled or the plain epilogue)
PATH_KERNELS = {"surface_scan_events": ("bin_events_kernel", "scan_events_kernel"),
                "fused_stem": ("fused_stem_kernel",), "conv_pool": ("conv_pool_kernel",),
                "conv_epilogue": ("pool_epilogue_kernel|act_epilogue_kernel",)}


def kernels_in_a_replay(pipe, items, want: dict) -> dict:
    """The hand-written kernels (K1, K6, C1, E1) that one replayed dispatch
    of ``pipe`` runs, counted by name in a torch.profiler trace of it, each
    against ``want`` (an eager dispatch's launches by counter).  A trace
    that lost records (fewer) is taken again on the next of ``items``, one
    dispatch each; one that holds more fails at once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for item in items:
        replays = pipe.stats["graph_replays"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            list(pipe.serve([item]))
            torch.cuda.synchronize()
        require(pipe.stats["graph_replays"] == replays + 1, "the profiled dispatch ran eagerly")
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        got = {launch: [sum(any(part in n for part in k.split("|")) for n in names)
                        for k in kernels] for launch, kernels in PATH_KERNELS.items()}
        seen.append(got)
        if all(c == [want[launch]] * len(c) for launch, c in got.items()):
            return {launch: c[0] for launch, c in got.items()}
        require(all(n <= want[launch] for launch, c in got.items() for n in c),
                f"a replay ran the kernels {got}, more than an eager dispatch's {want}")
    require(False, f"{len(items)} traces of a replay lost records: {seen}, against {want}")


@contextlib.contextmanager
def first_call(module, name: str):
    """Keeps the inputs and the output of the first call of ``module.name``
    made inside (the callers look it up in its module at each call), to
    hold that call against its plain version on the same inputs after the
    run; the spy carries the wrapper's name, which callers index counts
    by."""
    import functools

    real, seen = getattr(module, name), []

    @functools.wraps(real)
    def spy(*args, **kwargs):
        if seen:
            return real(*args, **kwargs)
        def keep(values):
            return tuple(a.clone() if torch.is_tensor(a) else a for a in values)

        kept = keep(args)
        out = real(*args, **kwargs)
        seen.append((kept, kwargs, out.clone() if torch.is_tensor(out) else keep(out)))
        return out

    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def k1_on_path():
    """:func:`first_call` of K1 (``integrate_parallel`` looks
    ``surface_scan_events`` up in its module at each call), checked by
    :func:`check_k1_on_path` after the run."""
    from async_ev_cnn_torch.ops import integrate as it

    return first_call(it, "surface_scan_events")


def check_k1_on_path(seen, what) -> str:
    """The kept K1 call bit-equal to its plain version; its shape."""
    from async_ev_cnn_torch.ops import surface_scan as sc

    require(len(seen) == 1, f"{what}: no K1 call on the path")
    args, _, out = seen[0]
    plain = sc.surface_scan_events_plain(*args)
    require(bit_equal(out, plain),
            f"{what}: K1 on the path's inputs {tuple(out.shape)} != its plain version")
    return "x".join(map(str, out.shape))


def serving_pipeline(model, streams, post, dev, wire="auto", max_in_flight=2):
    from async_ev_cnn_torch.utils.serving import StreamingPipeline

    return StreamingPipeline(model.net, model.params, capacity=CAPACITY, streams=streams,
                             t_chunks=SERVE_CHUNKS, wire=wire, postprocess=post,
                             max_in_flight=max_in_flight, device=dev)


def multistream_phase(model, num_classes, num_bbox, smi):
    """Phase 24 (this slice's main path): StreamingPipeline(streams=S,
    wire='auto') at full width, SERVE_CHUNKS chunks a stream a dispatch,
    S in SERVE_STREAMS, each stream a contiguous synthetic feed, items
    round-robin; the launch counts set to 0 just before each run and read
    just after (one K1 call a dispatch, on the stream axis for S > 1);
    the first dispatch's K1 call against its plain version on the same
    inputs; aggregate events/s over dispatches 2.., p50 dispatch latency, the tier;
    at S = 8 the outputs and end state against S one-stream pipelines; one
    more dispatch under torch.profiler (the card's busy share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from async_ev_cnn_torch.models import head
    from async_ev_cnn_torch.ops import surface_scan as sc

    def post(outs):  # the serve CLI's: boxes and class probs, leading axes kept
        boxes, _, probs = head.decode(outs, num_classes, num_bbox, H, W)
        return boxes, probs

    dev = model.device
    rows, info = [], {}
    for s in SERVE_STREAMS:
        rng = np.random.RandomState(24 + s)
        # one item a stream more than the counted run serves: the profiled one
        feeds = [np.split(synth_stream(rng, (SERVE_DISPATCHES + 1) * SERVE_CHUNKS, CAPACITY),
                          SERVE_DISPATCHES + 1) for _ in range(s)]
        source = [feeds[i][k] for k in range(SERVE_DISPATCHES) for i in range(s)]
        pipe = serving_pipeline(model, s, post, dev)
        sc.reset_launches()
        torch.cuda.synchronize()
        with k1_on_path() as seen:  # first dispatch: cuDNN set-up
            warm = list(pipe.serve(source[:s]))
        t0 = time.perf_counter()
        rest = list(pipe.serve(source[s:]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(sc.LAUNCHES)
        n_disp = SERVE_DISPATCHES
        # at S = 1 a key's first dispatch runs eagerly, its second captures
        # a CUDA graph and replays it, every later one replays it: K1 is
        # launched through its wrapper by the eager dispatches and the
        # captures
        made = pipe.stats["eager_dispatches"] + pipe.stats["graph_captures"]
        require(launches == (scan_launches(events=made) if s == 1 else
                             scan_launches(streams=n_disp)),
                f"S={s} serving launches {launches} for {n_disp} dispatches, {pipe.stats}")
        require(pipe.stats["eager_dispatches"] + pipe.stats["graph_replays"] == n_disp
                and (pipe.stats["graph_replays"] > 0) == (s == 1),
                f"S={s}: dispatched {pipe.stats}")
        k1_shape = check_k1_on_path(seen, f"S={s} serving")
        served = warm + rest
        require(len(served) == n_disp, f"S={s}: served {len(served)} of {n_disp}")
        if s == 1:  # every dispatch bit for bit an eager pipeline's
            with eager_dispatches():
                eager = list(serving_pipeline(model, 1, post, dev).serve(source))
            require(len(eager) == n_disp and all(
                bit_equal(x, y) for a, b in zip(served, eager)
                for x, y in zip(a.outputs, b.outputs)),
                "S=1: the graph path's dispatches differ from the eager pipeline's")
        lead = (SERVE_CHUNKS,) if s == 1 else (s, SERVE_CHUNKS)
        for r in served:
            boxes, probs = r.outputs
            require(boxes.shape[:-2] == lead and bool(torch.isfinite(boxes).all()
                                                      and torch.isfinite(probs).all()),
                    f"S={s}: decoded outputs {tuple(boxes.shape)} or not finite")
            require(r.n_events == s * SERVE_CHUNKS * CAPACITY, f"S={s}: {r.n_events} events")
        rate = sum(r.n_events for r in rest) / wall
        lat = pipe.latency_stats()
        info[s] = {"events_per_s": rate, "p50_ms": lat["dispatch_latency_ms"]["p50"],
                   "ms_per_dispatch": wall * 1e3 / (n_disp - 1), "tier": pipe.wire_tier,
                   "launches": launches, "k1_shape": k1_shape, "bytes_per_event":
                       pipe.stats["wire_bytes"] / pipe.stats["events"]}
        extra = ""
        if s == K1_STREAMS:
            out_err, bits = 0.0, True
            for i in range(s):
                one = serving_pipeline(model, 1, post, dev)
                for k, r in enumerate(one.serve(feeds[i][:SERVE_DISPATCHES])):
                    for a, b in zip(served[k].outputs, r.outputs):
                        out_err = max(out_err, float((a[i] - b).abs().max()))
                bits &= (bit_equal(pipe.state[0].surface[i], one.state[0].surface)
                         and int(pipe.state[0].prev_ts[i]) == int(one.state[0].prev_ts))
            require(bits, f"S={s}: a stream's end state != its one-stream pipeline's")
            require(out_err <= OUT_TOL, f"S={s}: outputs {out_err} from one-stream pipelines")
            info[s]["vs_single_max_abs"] = out_err
            extra = (f", end surfaces and prev_ts bit-equal to {s} one-stream pipelines, "
                     f"decoded outputs within {out_err:.3e}")
        # one more dispatch under torch.profiler: the card's busy share
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            list(pipe.serve([feeds[i][SERVE_DISPATCHES] for i in range(s)]))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in events
                      if e.device_type == DeviceType.CUDA) / 1e3
        top = sorted(((e.key, e.self_device_time_total) for e in events
                      if e.device_type == DeviceType.CPU), key=lambda e: -e[1])[:4]
        info[s].update(profiled_wall_ms=wall_ms, busy_ms=busy_ms)
        rows.append(f"S={s}: {rate:.0f} events/s ({info[s]['ms_per_dispatch']:.2f} ms a "
                    f"dispatch of {s} x {SERVE_CHUNKS} x {CAPACITY} events), p50 dispatch "
                    f"latency {info[s]['p50_ms']} ms, tier {pipe.wire_tier} "
                    f"({info[s]['bytes_per_event']:.4f} B/event), launches {launches}, "
                    f"the first dispatch's K1 call ({k1_shape}) bit-equal to its plain "
                    f"version{extra}; "
                    f"a profiled dispatch: wall {wall_ms:.2f} ms, device busy {busy_ms:.3f} ms "
                    f"({100 * busy_ms / wall_ms:.1f}%), most device time in "
                    + ", ".join(f"{k[:28]} {us / 1e3:.3f} ms" for k, us in top))
    # where a one-stream dispatch's time goes, layer by layer (utils/profiling:
    # prefix ablation timed by CUDA events)
    from async_ev_cnn_torch.utils.profiling import profile_layers_parallel
    from async_ev_cnn_torch.utils.runner import pack_chunks

    chunks = pack_chunks(synth_stream(np.random.RandomState(24), SERVE_CHUNKS, CAPACITY),
                         CAPACITY, device=dev)
    stages = profile_layers_parallel(model.net, model.params, chunks, reps=3, dispatches=4)
    info["stages"] = stages
    rows.append(f"stages of a T={SERVE_CHUNKS} one-stream dispatch (profile_layers_parallel, "
                "ms a dispatch): " + ", ".join(f"{n} {ms:.3f}" for n, ms in stages))
    print(f"serving: StreamingPipeline(wire='auto', max_in_flight=2, t_chunks={SERVE_CHUNKS}) "
          f"at {H}x{W}, {SERVE_DISPATCHES} dispatches, events/s over dispatches 2..: "
          + "; ".join(rows) + f"; card {smi!r}", flush=True)
    return info


def write_detection_tree(root: Path, rng, num_classes, args, train_examples=1):
    """A synthetic n-data detection tree at the config's example size:
    CLI_EXAMPLES test examples of CLI_EVENTS events (ts gaps of 1..14 µs),
    ``train_examples`` train examples and one validation example,
    annotations and params.npz."""
    from async_ev_cnn_torch.data.file_reader import NReader

    (root / "annotations").mkdir(parents=True)
    for split, k in (("train", train_examples), ("test", CLI_EXAMPLES), ("validation", 1)):
        (root / split).mkdir()
        for i in range(k):
            n = CLI_EVENTS
            x = rng.randint(0, args.example_w, n).astype(np.int32)
            y = rng.randint(0, args.example_h, n).astype(np.int32)
            ts = np.cumsum(rng.randint(1, 15, n)).astype(np.int32)
            p = rng.randint(0, 2, n).astype(np.int32)
            name = f"{split}_{i}"
            NReader().save_example(str(root / split / f"{name}.bin"), x, y, ts, p)
            np.save(str(root / "annotations" / f"{name}.npy"), rng.rand(1, 6).astype(np.float32))
    np.savez(str(root / "params.npz"), num_classes=num_classes,
             label_to_idx=np.array([(f"c{c}", c) for c in range(num_classes)], dtype=object))


def serve_cli_phase(dev, layer_defs, num_classes, smi):
    """Phase 25: ``python -m async_ev_cnn_torch.scripts.serve`` (its
    ``main``) on a synthetic n-data tree under a temporary directory with
    seeded weights, --num_streams 4 --serve_chunks 64 --out: the launches
    of the run (counts set to 0 just before, read just after), its first
    K1 call against its plain version on the same inputs, its stats
    and detections, and the same run without --out; then a --serve_state
    stop (after one dispatch) and resume, held bit for bit against one
    pipeline that serves the split twice without the stop (a run enqueues
    the whole split before its first dispatch retires, so the saved state
    is the split's end)."""
    import tempfile

    from async_ev_cnn_torch.data import detection_reader
    from async_ev_cnn_torch.models import head
    from async_ev_cnn_torch.models.yolo import YoloEventTorch
    from async_ev_cnn_torch.ops import surface_scan as sc
    from async_ev_cnn_torch.scripts import serve
    from async_ev_cnn_torch.utils.checkpoint import restore_stream_state, save_params
    from async_ev_cnn_torch.utils.config import config

    cfg = str(HERE / "configs" / "efcn_event.yml")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        args = config(["-c", cfg])
        write_detection_tree(tmp / "tree", np.random.RandomState(25), num_classes, args)
        ckpt = str(tmp / "efcn.npz")
        save_params(ckpt, make_params(layer_defs, np.random.RandomState(0)))
        base = ["-c", cfg, "--input_data_dir", str(tmp / "tree"), "--restore_net", ckpt,
                "--mode", "full", "--num_streams", str(CLI_STREAMS), "--serve_chunks",
                str(SERVE_CHUNKS), "--conf_threshold", "-10"]
        on_dev = ["--device", str(dev)]
        out = tmp / "dets.jsonl"
        sc.reset_launches()
        torch.cuda.synchronize()
        with contextlib.redirect_stdout(io.StringIO()), k1_on_path() as seen:
            stats = serve.main(base + on_dev + ["--out", str(out)])  # stats: returned too
        torch.cuda.synchronize()
        launches = dict(sc.LAUNCHES)
        k1_shape = check_k1_on_path(seen, "serve CLI")
        require(launches == scan_launches(streams=stats["dispatches"]),
                f"serve CLI launches {launches} for {stats['dispatches']} dispatches")
        n_lines = len(out.read_text().splitlines())
        require(stats["events"] > 0 and n_lines > 0 and stats["detections_written"] == n_lines,
                f"serve CLI stats {stats} against {n_lines} JSONL lines")
        # the same run without --out: nothing fetched a dispatch, no host NMS
        with contextlib.redirect_stdout(io.StringIO()):
            bare = serve.main(base + on_dev)
        require(bare["events"] == stats["events"], f"serve CLI without --out: {bare}")
        # stop after one dispatch, then resume from the saved state
        run = base + ["--serve_max_dispatches", "1", "--serve_state", str(tmp / "st.npz"),
                      "--out", str(tmp / "resume.jsonl")]
        with contextlib.redirect_stdout(io.StringIO()):
            first = serve.main(run + on_dev)
        n_first = len((tmp / "resume.jsonl").read_text().splitlines())
        with contextlib.redirect_stdout(io.StringIO()):
            second = serve.main(run + on_dev)
        resumed = (tmp / "resume.jsonl").read_text().splitlines()[n_first:]
        require(not first["state_restored"] and second["state_restored"] and resumed,
                "serve CLI stop/resume did not restore")
        # the uninterrupted reference: the split twice through one pipeline
        cargs = config(run)
        model = YoloEventTorch(
            args.frame_h, args.frame_w, num_classes, layer_defs, args.yolo_cnn_padding,
            args.yolo_num_cells_h, args.yolo_num_cells_w, args.yolo_num_bbox, alpha=0.1,
            leak=args.leak, conv_mode="full", checkpoint=ckpt, device=dev)

        def post(outs):
            boxes, _, probs = head.decode(outs, num_classes, args.yolo_num_bbox,
                                          args.frame_h, args.frame_w)
            return boxes, probs

        from async_ev_cnn_torch.utils.serving import StreamingPipeline

        pipe = StreamingPipeline(model.net, model.params, capacity=args.batch_event_size,
                                 streams=CLI_STREAMS, t_chunks=SERVE_CHUNKS,
                                 postprocess=post, device=dev)
        reader = detection_reader.factory(str(tmp / "tree"), file_format="n-data")
        items = [ev for _, ev in serve._stream_items(reader, cargs, CLI_STREAMS,
                                                     args.batch_event_size, SERVE_CHUNKS)]
        require(stats["events"] == sum(ev.shape[0] for ev in items),
                f"the serve CLI served {stats['events']} of the split's events")
        results = list(pipe.serve(items + items))
        with open(tmp / "ref.jsonl", "w") as fh:
            serve._write_detections(fh, results[len(items) // CLI_STREAMS], cargs, 0,
                                    CLI_STREAMS)
        require(resumed == (tmp / "ref.jsonl").read_text().splitlines(),
                "the resumed CLI's detections differ from the uninterrupted pipeline's")
        saved = restore_stream_state(str(tmp / "st.npz"), pipe.state)
        require(all(bit_equal(a.float(), b.float()) if a.is_floating_point() else
                    torch.equal(a, b) for sa, sb in zip(saved, pipe.state)
                    for a, b in zip(sa, sb)),
                "the resumed CLI's saved state differs from the uninterrupted pipeline's")
    print(f"serve-cli: scripts.serve --num_streams {CLI_STREAMS} --serve_chunks {SERVE_CHUNKS} "
          f"--out on {CLI_EXAMPLES} n-data examples of {CLI_EVENTS} events: "
          f"{stats['dispatches']} dispatches, {stats['events']} events, "
          f"{stats['events_per_sec']} events/s (file decode included), tier "
          f"{stats['wire_tier']} ({stats['wire_B_per_event']} B/event), "
          f"{stats['detections_written']} detections, p50 dispatch latency "
          f"{stats['latency']['dispatch_latency_ms']['p50']} ms, launches {launches}, the "
          f"first K1 call ({k1_shape}) bit-equal to its plain version; without "
          f"--out {bare['events_per_sec']} events/s, p50 dispatch latency "
          f"{bare['latency']['dispatch_latency_ms']['p50']} ms; "
          f"--serve_state stop after 1 dispatch and resume: {len(resumed)} detections and the "
          f"saved state bit-equal to the uninterrupted pipeline; card {smi!r}", flush=True)
    return stats


def data_plane_phase(dev, native_lib, smi):
    """Phase 26: the native decoder built from native/evio.cc into build/
    held bit-equal to the numpy codecs (n-data files and the OpenMP batch,
    EVT3, CRC-32C); device_prefetch delivering pinned batches to the card
    in order, each equal to its host batch."""
    import tempfile

    from async_ev_cnn_torch.data import native
    from async_ev_cnn_torch.data.evt import Evt3Reader
    from async_ev_cnn_torch.data.file_reader import NReader
    from async_ev_cnn_torch.data.prefetch import device_prefetch
    from async_ev_cnn_torch.utils import tf_bundle

    require(native.get_lib() is not None and native_lib.parent == native.BUILD_DIR,
            f"the native decoder is not loaded from {native.BUILD_DIR}")
    rng = np.random.RandomState(26)
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i in range(6):
            n = 50_000 + 1_000 * i
            x, y = rng.randint(0, 232, n), rng.randint(0, 172, n)
            ts = np.cumsum(rng.randint(1, 400, n))  # past 2^23 µs: overflow markers
            path = str(Path(tmp) / f"ex{i}.bin")
            NReader().save_example(path, x, y, ts, rng.randint(0, 2, n))
            paths.append(path)
        t0 = time.perf_counter()
        batch = native.decode_ndata_batch(paths)
        batch_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        numpy_out = [NReader.decode(np.fromfile(p, np.uint8)) for p in paths]
        numpy_ms = (time.perf_counter() - t0) * 1e3
        for path, got, want in zip(paths, batch, numpy_out):
            for a in (got, native.decode_ndata_file(path)):
                require(a[0] == want[0] and all(np.array_equal(u, v) and u.dtype == v.dtype
                                                for u, v in zip(a[1:], want[1:])),
                        f"native n-data decode of {Path(path).name} != the numpy codec's")
        evt = str(Path(tmp) / "ex.raw")
        n = 40_000
        Evt3Reader().save_example(evt, rng.randint(0, 1280, n), rng.randint(0, 720, n),
                                  np.cumsum(rng.randint(0, 300, n)), rng.randint(0, 2, n))
        got = Evt3Reader().read_example(evt)
        saved_lib = native._LIB
        native._LIB = None  # the numpy codec
        try:
            want = Evt3Reader().read_example(evt)
        finally:
            native._LIB = saved_lib
        require(got[0] == want[0] and all(np.array_equal(u, v) for u, v in zip(got[1:], want[1:])),
                "native EVT3 decode != the numpy codec's")
    data = rng.randint(0, 256, 1 << 16).astype(np.uint8).tobytes()
    table = tf_bundle._crc_tables()[0]
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    require(native.crc32c(data) == crc ^ 0xFFFFFFFF, "native CRC-32C != the table loop's")

    host = [[rng.randint(0, 2**31 - 1, (SERVE_CHUNKS, CAPACITY)).astype(np.int32),
             {"counts": np.full(SERVE_CHUNKS, i, np.int32)}] for i in range(16)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = []
    for planes, meta in device_prefetch(iter(host), size=2, device=dev):
        require(planes.device == dev and meta["counts"].device == dev,
                "device_prefetch delivered a batch off the card")
        got.append((planes.sum(dtype=torch.int64), meta["counts"][0]))
    torch.cuda.synchronize()
    pf_ms = (time.perf_counter() - t0) * 1e3
    for i, (a, c) in enumerate(got):
        require(int(a) == int(host[i][0].astype(np.int64).sum()) and int(c) == i,
                f"device_prefetch batch {i} out of order or changed")
    mb = sum(b[0].nbytes + b[1]["counts"].nbytes for b in host) / 2**20
    print(f"data-plane: native/evio.cc built into {native_lib.parent.relative_to(HERE)} "
          f"({native_lib.name}); n-data batch of {len(paths)} files decoded natively in "
          f"{batch_ms:.1f} ms (numpy codec {numpy_ms:.1f} ms), bit-equal, and per file; EVT3 "
          f"and CRC-32C bit-equal; device_prefetch: {len(got)} pinned batches ({mb:.2f} MB) "
          f"delivered to the card in order and equal to the host's in {pf_ms:.1f} ms; card "
          f"{smi!r}", flush=True)


# ---- training and the CLIs (phases 27-29) --------------------------------------

TRAIN_BATCH = 16
# C + B*5 = 110, conv7's width in configs/efcn_event.yml
TRAIN_CLASSES = 100
TRAIN_BATCHES = 4
TRAIN_EVENTS = 20_000
TRAIN_STEPS = 30
TRAIN_TIMED = slice(10, 30)
TRAIN_RESUME = 4
# the card's first training step against the CPU's at 'highest', both IEEE
# float32 with the convs' sums in other orders: the loss within
# TRAIN_LOSS_RTOL, each gradient within TRAIN_GRAD_TOL of that tensor's
# largest gradient magnitude (the forward's conv-stack contract is 1e-4 a
# layer; a gradient sums over the batch and the frame besides)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
CLI_TRAIN_EXAMPLES = 8


def check_k3_on_path(seen, what) -> float:
    """The kept K3 call within KERNEL_REL_TOL * (1 + max |plain|) of its
    plain version (phase 7's tolerance); its largest difference."""
    from async_ev_cnn_torch.ops import rulebook_gemm as rg

    require(len(seen) == 1, f"{what}: no K3 call on the path")
    args, kwargs, out = seen[0]
    plain = rg.rulebook_gather_gemm_blocks_plain(*args)
    err = max(float((a - b).abs().max()) for a, b in zip(out, plain))
    scale = max(float(p.abs().max()) for p in plain)
    require(err <= KERNEL_REL_TOL * (1 + scale),
            f"{what}: K3 on the path's inputs differs from its plain version by {err}")
    return err


def train_batches(dev, args, rng, n_batches):
    """``n_batches`` batches of TRAIN_BATCH frames, each integrated on the
    card from a seeded uniform stream of TRAIN_EVENTS events
    (``integrate_frame_chunked``, as the train CLI does), with grid targets
    from ``build_targets`` of 1-3 seeded boxes a frame."""
    from async_ev_cnn_torch.models.train import YoloTargets
    from async_ev_cnn_torch.ops.integrate import integrate_frame_chunked
    from async_ev_cnn_torch.scripts.train import build_targets

    sh, sw = args.yolo_num_cells_h, args.yolo_num_cells_w
    batches = []
    for _ in range(n_batches):
        frames, grids = [], []
        for _ in range(TRAIN_BATCH):
            events = synth_stream(rng, 1, TRAIN_EVENTS)
            frames.append(integrate_frame_chunked(events, args.leak, H, W, device=dev)[0])
            k = rng.randint(1, 4)
            boxes = np.concatenate([rng.uniform(0.05, 0.95, (k, 2)),
                                    rng.uniform(0.05, 0.5, (k, 2)),
                                    rng.randint(0, TRAIN_CLASSES, (k, 1)),
                                    np.zeros((k, 1))], axis=1).astype(np.float32)
            grids.append(build_targets(boxes, sh, sw))
        targets = YoloTargets(*(torch.from_numpy(np.stack(t)).to(dev) for t in zip(*grids)))
        batches.append((torch.stack(frames), targets))
    return batches


def profile_step(fresh, batches, warm: int = 3) -> str:
    """One training step (after ``warm`` steps) under torch.profiler: its
    wall time, the device's busy share of it, and the ops that take the
    most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer, params, opt = fresh()
    for i in range(warm):
        params, opt, _ = trainer.step(params, opt, *batches[i % len(batches)])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(params, opt, *batches[warm % len(batches)])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA) / 1e3
    ops = sorted(((e.key, e.self_device_time_total) for e in events
                  if e.device_type == DeviceType.CPU), key=lambda e: -e[1])[:6]
    return (f"wall {wall_ms:.2f} ms, device busy {busy_ms:.3f} ms "
            f"({100 * busy_ms / wall_ms:.1f}%), most device time in "
            + ", ".join(f"{k[:40]} {us / 1e3:.3f} ms" for k, us in ops))


def trainer_phase(dev, args, smi):
    """Phase 27: the trainer on the full-width eFCN (configs/efcn_event.yml,
    TRAIN_CLASSES classes so that C + B*5 is conv7's width), the train
    CLI's seeded init, batches of TRAIN_BATCH frames integrated on the
    card: the first step's loss and every gradient against the same step
    on the CPU at 'highest', the CPU's max-pools routed as the card's
    forward routed them (and the windows routed otherwise counted), with
    the cuDNN and cuBLAS flags that the backward pass ran under, and the
    distance at 'default'; TRAIN_STEPS Adam steps at 'highest' and at
    'default' (the loss finite and falling; the median ms a step over
    TRAIN_TIMED by CUDA events, frames/s, peak device memory), and at
    'highest' with cuDNN free to choose its algorithms; then 8 steps
    against 4, a save (.npz + .opt.npz), a fresh Trainer resumed from them
    and 4 more: parameters and moments bit-equal."""
    import tempfile

    from async_ev_cnn_torch.layers.network import EventNetwork
    from async_ev_cnn_torch.models import train as tt
    from async_ev_cnn_torch.ops.conv import _apply_tier, set_matmul_precision
    from async_ev_cnn_torch.scripts.train import init_params
    from async_ev_cnn_torch.utils.checkpoint import load_params, save_params
    from async_ev_cnn_torch.utils.weights import params_from_jax, params_to_jax

    layer_defs = args.yolo_cnn_layers
    num_bbox = args.yolo_num_bbox
    grid = (args.yolo_num_cells_h, args.yolo_num_cells_w)
    require(TRAIN_CLASSES + 5 * num_bbox == list(layer_defs.values())[-1][3],
            "conv7's width is not C + B*5")
    net = EventNetwork(layer_defs, H, W, leak=args.leak, alpha=0.1,
                       padding=args.yolo_cnn_padding)
    init = init_params(layer_defs)
    batches = train_batches(dev, args, np.random.RandomState(27), TRAIN_BATCHES)
    cpu = torch.device("cpu")

    def fresh(where=dev, start=init):
        trainer = tt.Trainer(net, TRAIN_CLASSES, num_bbox, grid)
        params = params_from_jax(start, where)
        return trainer, params, trainer.init(params)

    @contextlib.contextmanager
    def pool_routing(replay=None):
        """``dense_forward``'s max-pools with their argmax kept (in call
        order), or, given ``replay``, routed by those kept on another run:
        the pools' values and gradients then go through the same window
        elements as there (a pool's gradient jumps where two window values
        tie to rounding, so two devices' roundings may route it apart)."""
        import torch.nn.functional as F

        from async_ev_cnn_torch.layers import network as tnet

        real, kept, flips = tnet.maxpool_dense, [], []

        def pool(x, ksize, stride, padding="VALID"):
            out, idx = F.max_pool2d(x, ksize, stride, return_indices=True)
            if replay is None:
                kept.append(idx)
                return out
            route = replay[len(flips)].to(x.device)
            flips.append(int((idx != route).sum()))
            return x.flatten(-2).gather(-1, route.flatten(-2)).view(route.shape)

        tnet.maxpool_dense = pool
        try:
            yield kept, flips
        finally:
            tnet.maxpool_dense = real

    def first_step(where, replay=None):
        trainer, params, opt = fresh(where)
        frames, targets = batches[0]
        flags = []
        params["w_conv1"].register_hook(lambda g: flags.append(
            (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)))
        with pool_routing(replay) as (kept, flips):
            _, _, loss = trainer.step(params, opt, frames.to(where),
                                      tt.YoloTargets(*(t.to(where) for t in targets)))
        grads = params_to_jax({k: p.grad for k, p in params.items()})
        return float(loss), grads, flags, kept, flips

    def cudnn_free(device):  # the tier's flags, cuDNN free to choose algorithms
        _apply_tier()
        return contextlib.nullcontext()

    try:
        # ---- the first step, card against CPU ----
        set_matmul_precision("highest")
        loss_c, grads_c, flags_c, routes, _ = first_step(dev)
        loss_h, grads_h, _, _, _ = first_step(cpu)
        # the CPU's step again, each pool routed as on the card
        loss_r, grads_r, _, _, flips = first_step(cpu, replay=routes)
        set_matmul_precision("default")
        _, grads_t, flags_t, _, _ = first_step(dev)
        set_matmul_precision("highest")
        require(flags_c == [(False, False, True)],
                f"the backward at 'highest' ran under (cudnn tf32, cublas tf32, "
                f"deterministic) = {flags_c}")
        require(flags_t == [(True, True, True)], f"the backward at 'default' ran under {flags_t}")
        require(torch.backends.cudnn.deterministic is False,
                "the trainer left cuDNN's deterministic flag on")

        def rel_errs(grads, ref):
            return {k: float(np.abs(grads[k] - ref[k]).max() / np.abs(ref[k]).max())
                    for k in ref}

        errs = rel_errs(grads_c, grads_r)
        own_errs, tf32_errs = rel_errs(grads_c, grads_h), rel_errs(grads_t, grads_r)
        require(np.isfinite(loss_c) and all(abs(loss_c - x) <= TRAIN_LOSS_RTOL * abs(x)
                                            for x in (loss_h, loss_r)),
                f"the card's first loss {loss_c} against the CPU's {loss_h} ({loss_r} "
                "routed as on the card)")
        worst = max(errs, key=errs.get)
        require(errs[worst] <= TRAIN_GRAD_TOL,
                f"the card's gradient of {worst} differs from the CPU's (pools routed as on "
                f"the card) by {errs[worst]:.2e} of its largest")

        # ---- TRAIN_STEPS Adam steps at two tiers; the step's options ----
        def run(steps):
            trainer, params, opt = fresh()
            losses, ms = [], []
            torch.cuda.reset_peak_memory_stats()
            for i in range(steps):
                frames, targets = batches[i % len(batches)]
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                params, opt, loss = trainer.step(params, opt, frames, targets)
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
                losses.append(float(loss))
            require(all(np.isfinite(losses)) and np.mean(losses[-5:]) < losses[0],
                    f"the loss did not fall over {steps} steps: {losses}")
            step_ms = float(np.median(ms[TRAIN_TIMED]))
            return {"first_loss": losses[0], "last_loss": losses[-1], "step_ms": step_ms,
                    "frames_s": TRAIN_BATCH / step_ms * 1e3,
                    "mem_mib": torch.cuda.max_memory_allocated() / 2**20}

        tiers = {}
        for tier in ("highest", "default"):
            set_matmul_precision(tier)
            tiers[tier] = run(TRAIN_STEPS)
        set_matmul_precision("highest")
        real_flags, tt._step_flags = tt._step_flags, cudnn_free
        try:
            free_step_ms = run(TRAIN_STEPS)["step_ms"]
        finally:
            tt._step_flags = real_flags
        profile = profile_step(fresh, batches)

        # ---- resume: 8 steps against 4 + save + a fresh Trainer + 4 ----
        def steps(trainer, params, opt, first, n):
            for i in range(first, first + n):
                frames, targets = batches[i % len(batches)]
                params, opt, _ = trainer.step(params, opt, frames, targets)
            return params, opt

        trainer, full, full_opt = fresh()
        full, full_opt = steps(trainer, full, full_opt, 0, 2 * TRAIN_RESUME)
        trainer, mid, mid_opt = fresh()
        mid, mid_opt = steps(trainer, mid, mid_opt, 0, TRAIN_RESUME)
        with tempfile.TemporaryDirectory() as tmp:
            save_params(f"{tmp}/mid.npz", params_to_jax(mid))
            tt.save_adam_state(f"{tmp}/mid.opt.npz", mid, mid_opt)
            trainer, res, res_opt = fresh(start=load_params(f"{tmp}/mid.npz"))
            tt.restore_adam_state(f"{tmp}/mid.opt.npz", res, res_opt)
        res, res_opt = steps(trainer, res, res_opt, TRAIN_RESUME, TRAIN_RESUME)
        torch.cuda.synchronize()
        for k in full:
            require(bit_equal(res[k].detach(), full[k].detach()),
                    f"resumed {k} differs from the uninterrupted run's")
            for m in ("exp_avg", "exp_avg_sq"):
                require(bit_equal(res_opt.state[res[k]][m], full_opt.state[full[k]][m]),
                        f"resumed {m} of {k} differs from the uninterrupted run's")
    finally:
        set_matmul_precision("highest")
    h, d = tiers["highest"], tiers["default"]
    print(f"trainer: eFCN {H}x{W} conv1..conv7, {TRAIN_CLASSES} classes, batch {TRAIN_BATCH} "
          f"frames of {TRAIN_EVENTS} events integrated on the card; first step card against "
          f"CPU at 'highest': loss {loss_c:.6f} / {loss_h:.6f}; with the CPU's pools routed "
          f"as on the card, gradients within {errs[worst]:.2e} of each tensor's largest "
          f"(worst {worst}; tolerance {TRAIN_GRAD_TOL}; at 'default' "
          f"{max(tf32_errs.values()):.2e}); pool windows routed otherwise on the CPU "
          f"{flips} (pool1..pool5 of {[int(r.numel()) for r in routes]}), the gradients of "
          f"each routing {max(own_errs.values()):.2e} apart (worst "
          f"{max(own_errs, key=own_errs.get)}); backward under (cudnn tf32, cublas tf32, "
          f"deterministic) {flags_c[0]} at 'highest' and {flags_t[0]} at 'default'; "
          f"{TRAIN_STEPS} Adam steps: 'highest' loss "
          f"{h['first_loss']:.3f} -> {h['last_loss']:.3f}, {h['step_ms']:.3f} ms a step "
          f"(median of steps {TRAIN_TIMED.start}-{TRAIN_TIMED.stop}), {h['frames_s']:.1f} "
          f"frames/s, peak {h['mem_mib']:.1f} MiB; 'default' loss {d['first_loss']:.3f} -> "
          f"{d['last_loss']:.3f}, {d['step_ms']:.3f} ms, {d['frames_s']:.1f} frames/s, peak "
          f"{d['mem_mib']:.1f} MiB; 'highest' without cuDNN's deterministic choice "
          f"{free_step_ms:.3f} ms a step; resume ({2 * TRAIN_RESUME} steps against "
          f"{TRAIN_RESUME} + .npz/.opt.npz + {TRAIN_RESUME}): parameters and moments "
          f"bit-equal; a profiled 'highest' step: {profile}; card {smi!r}", flush=True)
    return {"highest": h, "default": d, "free_step_ms": free_step_ms}


def cli_phases(dev, args, num_classes, smi):
    """Phases 28 and 29 on one synthetic n-data tree under a temporary
    directory (phase 25's writer with CLI_TRAIN_EXAMPLES train examples).

    28: ``scripts.train`` (its main) at full width with --checkpoint_every,
    then --resume_from its checkpoint, then ``scripts.evaluate`` on the
    resumed checkpoint in 'dense' and in 'sparse_pallas' (the K3/K4 counts
    set to 0 just before and read just after, the first K3 call held
    against its plain version): each run's JSON line and wall time.

    29: ``scripts.run_networks`` on the same tree and checkpoint: the step
    runner in 'sparse_pallas' (K3/K4 counted, the first K3 call held), the
    scan runner on configs/efcn_event_full.yml (K1 counted, its first call
    bit-equal to its plain version), the scan runner with --ts_window (the
    'events' engine ignores the window, in both packages: K1 again, K2 not
    launched), the multi-stream runner with --num_streams 2 in this process
    (an NCCL world of 1; K1 counted, its first call bit-equal to its plain
    version) and in a process started with torchrun's environment, and
    YoloFrameJax through the frame runner: each run's stats line."""
    import tempfile

    from async_ev_cnn_torch.ops import rulebook_gemm as rg
    from async_ev_cnn_torch.ops import surface_scan as sc
    from async_ev_cnn_torch.scripts import evaluate, run_networks, train
    from async_ev_cnn_torch.scripts.train import opt_state_path
    from async_ev_cnn_torch.utils.config import config

    cfg = str(HERE / "configs" / "efcn_event.yml")
    full_cfg = str(HERE / "configs" / "efcn_event_full.yml")
    on_dev = ["--device", str(dev)]

    def scored(line):
        """evaluate's JSON line with ``ap_per_class`` cut to the classes
        that have ground truth (the others are null)."""
        aps = line["ap_per_class"]
        return {**{k: v for k, v in line.items() if k != "ap_per_class"},
                "ap_per_class (classes with ground truth)":
                    {i: a for i, a in enumerate(aps) if a is not None}}

    def timed(main, argv):
        """A CLI's main with its standard output kept: its value, its last
        line as JSON, its wall time in s."""
        out = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            value = main(argv + on_dev)
        torch.cuda.synchronize()
        return value, json.loads(out.getvalue().strip().splitlines()[-1]), \
            time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        tree = str(tmp / "tree")
        write_detection_tree(Path(tree), np.random.RandomState(28), num_classes,
                             config(["-c", cfg]), train_examples=CLI_TRAIN_EXAMPLES)
        data = ["--input_data_dir", tree]
        # ---- 28. train, resume, evaluate ----
        ckpt, resumed = str(tmp / "efcn.npz"), str(tmp / "efcn_resumed.npz")
        _, first, first_s = timed(train.main, ["-c", cfg, *data, "--train_steps", "4",
                                               "--batch_size", "4", "--checkpoint_every", "2",
                                               "--log_every", "1", "--save_to", ckpt])
        _, second, second_s = timed(train.main, ["-c", cfg, *data, "--train_steps", "2",
                                                 "--batch_size", "4", "--resume_from", ckpt,
                                                 "--save_to", resumed])
        for line in (first, second):
            require(np.isfinite(line["final_loss"]), f"train CLI: {line}")
        with np.load(opt_state_path(resumed)) as z:
            require(int(z["leaf_0"]) == 6, f"the resumed run's Adam count {z['leaf_0']}")
        evals = {}
        for mode in ("dense", "sparse_pallas"):
            rg.reset_launches()
            with first_call(rg, "rulebook_gather_gemm_blocks") as seen:
                result, line, secs = timed(evaluate.main, ["-c", cfg, *data, "--restore_net",
                                                           resumed, "--mode", mode])
            launches = dict(rg.LAUNCHES)
            require(line["examples"] == CLI_EXAMPLES and 0.0 <= result["mAP"] <= 1.0,
                    f"evaluate in {mode!r}: {line}")
            if mode == "sparse_pallas":
                require(launches["rulebook_gather_gemm_blocks"] > 0
                        and launches["rulebook_gather_gemm"] == 0,
                        f"evaluate in 'sparse_pallas' launched {launches} (stride-1 eFCN: "
                        "K3 only)")
                k3_err = check_k3_on_path(seen, "evaluate --mode sparse_pallas")
            else:
                require(launches == {"rulebook_gather_gemm_blocks": 0,
                                     "rulebook_gather_gemm": 0},
                        f"evaluate in 'dense' launched {launches}")
            evals[mode] = (line, secs, launches)
        print(f"train-evaluate-cli: scripts.train on {CLI_TRAIN_EXAMPLES} n-data train "
              f"examples of {CLI_EVENTS} events at {H}x{W}, 4 steps of batch 4 with "
              f"--checkpoint_every 2: {json.dumps(first)} in {first_s:.2f} s; --resume_from "
              f"for 2 more: {json.dumps(second)} in {second_s:.2f} s (Adam count 6); "
              "scripts.evaluate on the resumed checkpoint over "
              f"{CLI_EXAMPLES} test examples: " + "; ".join(
                  f"{mode}: {json.dumps(scored(line))} in {secs:.2f} s, launches {launches}"
                  for mode, (line, secs, launches) in evals.items())
              + f"; the first K3 call within {k3_err:.2e} of its plain version; card {smi!r}",
              flush=True)

        # ---- 29. run_networks ----
        runs = []
        rg.reset_launches()
        with first_call(rg, "rulebook_gather_gemm_blocks") as seen:
            stats, _, secs = timed(run_networks.main, ["-c", cfg, *data, "--restore_net",
                                                       resumed, "--mode", "sparse_pallas"])
        launches = dict(rg.LAUNCHES)
        require(launches["rulebook_gather_gemm_blocks"] > 0
                and launches["rulebook_gather_gemm"] == 0,
                f"run_networks 'sparse_pallas' launched {launches}")
        k3_err = check_k3_on_path(seen, "run_networks --mode sparse_pallas")
        runs.append(("step runner, 'sparse_pallas'", stats, secs,
                     f"launches {launches}, the first K3 call within {k3_err:.2e} of plain"))
        for what, extra in (("scan runner, efcn_event_full.yml", []),
                            ("scan runner, --ts_window 16", ["--ts_window", "16"])):
            sc.reset_launches()
            with k1_on_path() as seen_k1:
                stats, _, secs = timed(run_networks.main, ["-c", full_cfg, *data,
                                                           "--restore_net", resumed, *extra])
            launches = dict(sc.LAUNCHES)
            require(stats["examples"] == CLI_EXAMPLES
                    and launches == scan_launches(events=CLI_EXAMPLES),
                    f"run_networks {what}: {stats}, launches {launches}")
            k1_shape = check_k1_on_path(seen_k1, f"run_networks {what}")
            runs.append((what, stats, secs, f"launches {launches}, the first K1 call "
                         f"({k1_shape}) bit-equal to its plain version"))
        # --num_streams 2: the world starts before the network is built
        sc.reset_launches()
        with k1_on_path() as seen_k1:
            stats, _, secs = timed(run_networks.main, ["-c", full_cfg, *data, "--restore_net",
                                                       resumed, "--num_streams", "2"])
        launches = dict(sc.LAUNCHES)
        require(stats["examples"] == CLI_EXAMPLES
                and launches == scan_launches(streams=CLI_EXAMPLES // 2),
                f"run_networks --num_streams 2: {stats}, launches {launches}")
        k1_shape = check_k1_on_path(seen_k1, "run_networks --num_streams 2")
        runs.append(("multi-stream runner, --num_streams 2, an NCCL world of 1", stats, secs,
                     f"launches {launches}, the first K1 call ({k1_shape}) bit-equal to its "
                     "plain version"))
        stats, secs = rank_process(["-m", "async_ev_cnn_torch.scripts.run_networks", "-c",
                                    full_cfg, *data, "--restore_net", resumed,
                                    "--num_streams", "2", *on_dev])
        require(stats["examples"] == CLI_EXAMPLES and stats["events_per_sec"] > 0,
                f"run_networks --num_streams 2 under torchrun's environment: {stats}")
        runs.append(("multi-stream runner, --num_streams 2, a process with torchrun's "
                     "environment (env:// rendezvous, an NCCL world of 1)", stats, secs,
                     "start-up included"))
        stats, _, secs = timed(run_networks.main, ["-c", cfg, *data, "--restore_net", resumed,
                                                   "--network", "YoloFrameJax"])
        require(stats["steps"] > 0 and stats["events_per_sec"] > 0,
                f"run_networks YoloFrameJax: {stats}")
        runs.append(("YoloFrameJax, frame runner", stats, secs, "cuDNN only"))
    print(f"run-networks-cli: scripts.run_networks on the same {CLI_EXAMPLES} test examples: "
          + "; ".join(f"{what}: {json.dumps(stats)} in {secs:.2f} s, {note}"
                      for what, stats, secs, note in runs) + f"; card {smi!r}", flush=True)
    return evals, runs


def rank_process(argv) -> tuple[dict, float]:
    """``python argv`` in a process of its own with the environment that
    ``torchrun --nproc_per_node 1`` gives its rank (the env:// rendezvous
    on 127.0.0.1 at a free port); its last line as JSON and its wall s."""
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *argv], cwd=HERE, env=env, capture_output=True,
                          text=True, timeout=600)
    secs = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"{' '.join(argv)} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1]), secs


# ---- phases 30-31: the multi-device layer ------------------------------------

MESH_STREAMS = 8
MESH_CHUNKS = 64
MESH_SEQ_STREAMS = 2
MESH_SEQ_CHUNKS = 8
MESH_RANKS = 4
# the engines against the meshless paths where the same kernels run the same
# work in another batching: the 1e-4 contract of the conv stack
MESH_TOL = 1e-4


def mesh_batches(dev, rng, s, t):
    """``s`` synthetic feeds of ``t`` chunks as ``[T, S, E]`` chunks on
    ``dev``."""
    from async_ev_cnn_torch.layers.types import EventChunk
    from async_ev_cnn_torch.utils.runner import pack_chunks

    parts = [pack_chunks(synth_stream(rng, t, CAPACITY), CAPACITY, device=dev)
             for _ in range(s)]
    return EventChunk(*(torch.stack(f, dim=1) for f in zip(*parts)))


def mesh_phase(dev, args, model, num_classes, num_bbox, smi):
    """Phase 30: the one-card deployment, an NCCL world of 1 (a HashStore,
    as without torchrun), at full width with the seeded weights at
    'highest': MultiStreamEngine.scan_parallel on make_mesh(1, 1) for
    MESH_STREAMS streams of MESH_CHUNKS chunks, outputs and end surfaces
    bit-equal to the meshless scan_parallel on the same [S, T, E] (K1
    counted: one launch pair, the window holds every chunk; its call
    bit-equal to its plain version); MultiStreamEngine.scan in
    'sparse_pallas' on MESH_SEQ_STREAMS clustered streams of
    MESH_SEQ_CHUNKS chunks within MESH_TOL of each stream's own
    YoloEventTorch.scan (K3 counted, its first call held as in phase 28);
    TimeShardEngine on a time mesh of 1 within MESH_TOL of scan_parallel,
    with its three collectives counted and the NCCL all_gather of a
    C*H*W plane timed; StreamingPipeline(streams=8, mesh=...) for
    SERVE_DISPATCHES dispatches of SERVE_CHUNKS chunks, results and end
    state bit-equal to the meshless pipeline's, events/s and p50 of both
    (K1 counted, its first call held); Trainer(mesh) one step at batch
    TRAIN_BATCH bit-equal to Trainer(mesh=None).  Returns what phase 31
    and the JSON line read."""
    import torch.distributed as dist

    from async_ev_cnn_torch.layers.network import EventNetwork
    from async_ev_cnn_torch.layers.types import EventChunk
    from async_ev_cnn_torch.models import head
    from async_ev_cnn_torch.models.train import Trainer
    from async_ev_cnn_torch.models.yolo import YoloEventTorch
    from async_ev_cnn_torch.ops import rulebook_gemm as rg
    from async_ev_cnn_torch.ops import surface_scan as sc
    from async_ev_cnn_torch.parallel import (
        MultiStreamEngine,
        TimeShardEngine,
        make_mesh,
        make_time_mesh,
        world,
    )
    from async_ev_cnn_torch.scripts.train import init_params
    from async_ev_cnn_torch.utils.serving import StreamingPipeline
    from async_ev_cnn_torch.utils.weights import params_from_jax

    layer_defs = args.yolo_cnn_layers
    s, t = MESH_STREAMS, MESH_CHUNKS
    info = {}
    t0 = time.perf_counter()
    with world(dev):
        mesh = make_mesh(1, 1, device=dev)
        info["start_ms"] = (time.perf_counter() - t0) * 1e3
        require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
                f"the one-card world is {dist.get_backend()} x {dist.get_world_size()}")

        # -- MultiStreamEngine.scan_parallel against the meshless call
        eng = MultiStreamEngine(model.net, mesh)
        chunks = mesh_batches(torch.device("cpu"), np.random.RandomState(30), s, t)
        params = eng.place_params(model.params)
        states = eng.init_states(model.params, s)
        local = eng.place_chunks(chunks, leading_time=True)

        def sharded():
            return eng.scan_parallel(params, states, local)

        base = model.init_state()
        st0 = tuple(type(x)(*(f.expand(s, *f.shape) for f in x)) for x in base)
        ste = EventChunk(*(f.transpose(0, 1).contiguous().to(dev) for f in chunks))

        def meshless():
            return model.net.scan_parallel(model.params, st0, ste, window=256)

        sharded()  # cuDNN set-up
        sc.reset_launches()
        torch.cuda.synchronize()
        with k1_on_path() as seen:
            st_m, out_m = sharded()
        torch.cuda.synchronize()
        launches = dict(sc.LAUNCHES)
        require(launches == scan_launches(streams=1),
                f"mesh scan_parallel launches {launches} for one window")
        k1_shape = check_k1_on_path(seen, "mesh scan_parallel")
        st_r, out_r = meshless()
        require(bit_equal(out_m, out_r.transpose(0, 1))
                and bit_equal(st_m[0].surface, st_r[0].surface),
                "mesh scan_parallel differs from the meshless call")
        n_ev = int(chunks.valid.sum())
        info.update(scan_launches=launches, engine_ms=time_ms(sharded, 3, 3),
                    meshless_ms=time_ms(meshless, 3, 3), chunks=chunks,
                    outs=out_m.cpu())
        rows = [f"MultiStreamEngine.scan_parallel S={s} T={t}: outputs and end surfaces "
                f"bit-equal to the meshless scan_parallel, launches {launches}, the K1 call "
                f"({k1_shape}) bit-equal to its plain version, {info['engine_ms']:.3f} ms "
                f"({n_ev / info['engine_ms'] * 1e3:.0f} events/s) against "
                f"{info['meshless_ms']:.3f} ms meshless"]

        # -- MultiStreamEngine.scan in 'sparse_pallas' against per-stream scans
        sp = YoloEventTorch(
            args.frame_h, args.frame_w, num_classes, layer_defs, args.yolo_cnn_padding,
            args.yolo_num_cells_h, args.yolo_num_cells_w, num_bbox, alpha=0.1,
            leak=args.leak, conv_mode="sparse_pallas", capacity_frac=CAPACITY_FRAC,
            device=dev)
        sp.set_weights(make_params(layer_defs, np.random.RandomState(0)))
        eng_sp = MultiStreamEngine(sp.net, mesh)
        seq = [make_stream_chunks(np.random.RandomState(31 + i), MESH_SEQ_CHUNKS, dev)
               for i in range(MESH_SEQ_STREAMS)]
        seq_tse = EventChunk(*(torch.stack(f, dim=1) for f in zip(*seq)))
        rg.reset_launches()
        sc.reset_launches()
        torch.cuda.synchronize()
        with first_call(rg, "rulebook_gather_gemm_blocks") as seen_k3:
            _, out_sp = eng_sp.scan(eng_sp.place_params(sp.params),
                                    eng_sp.init_states(sp.params, MESH_SEQ_STREAMS), seq_tse)
        torch.cuda.synchronize()
        k3_launches = dict(rg.LAUNCHES)
        require(k3_launches["rulebook_gather_gemm_blocks"] > 0,
                f"mesh scan in 'sparse_pallas' launched no K3: {k3_launches}")
        k3_err = check_k3_on_path(seen_k3, "mesh scan 'sparse_pallas'")
        seq_err = max(float((out_sp[:, i] - sp.scan(sp.init_state(), part)[1]
                             .reshape(out_sp[:, i].shape)).abs().max())
                      for i, part in enumerate(seq))
        require(seq_err <= MESH_TOL,
                f"mesh scan 'sparse_pallas' {seq_err} from per-stream scans")
        info["k3_launches"] = k3_launches["rulebook_gather_gemm_blocks"]
        rows.append(f"MultiStreamEngine.scan 'sparse_pallas' {MESH_SEQ_STREAMS} streams x "
                    f"{MESH_SEQ_CHUNKS} clustered chunks: within {seq_err:.3e} of per-stream "
                    f"YoloEventTorch.scan, K3 launches {info['k3_launches']}, the first K3 "
                    f"call within {k3_err:.2e} of its plain version")

        # -- TimeShardEngine on a time mesh of 1 against scan_parallel
        te = TimeShardEngine(model.net, make_time_mesh(1, device=dev))
        one = EventChunk(*(f[:, 0].to(dev) for f in chunks))
        te.time.calls.clear()
        st_t, out_t = te.scan_parallel(model.params, base, one)
        calls = sorted(te.time.calls.items())
        st_p, out_p = model.net.scan_parallel(model.params, base, one)
        ts_err = max(float((out_t - out_p).abs().max()),
                     float((st_t[0].surface - st_p[0].surface).abs().max()))
        require(ts_err <= MESH_TOL, f"time shard {ts_err} from scan_parallel")
        plane = torch.zeros((1, 1, H, W), device=dev)
        gather_ms = time_ms(lambda: te.time.all_gather(plane), 20)
        info["allgather_ms"] = gather_ms
        rows.append(f"TimeShardEngine (time mesh of 1) T={t}: within {ts_err:.3e} of "
                    f"scan_parallel, collectives {calls}; NCCL all_gather of a 1x{H}x{W} "
                    f"float32 plane {gather_ms:.4f} ms")

        # -- the mesh pipeline against the meshless one
        def post(outs):
            boxes, _, probs = head.decode(outs, num_classes, num_bbox, H, W)
            return boxes, probs

        rng = np.random.RandomState(32)
        feeds = [np.split(synth_stream(rng, SERVE_DISPATCHES * SERVE_CHUNKS, CAPACITY),
                          SERVE_DISPATCHES) for _ in range(s)]
        source = [feeds[i][k] for k in range(SERVE_DISPATCHES) for i in range(s)]
        served, pipes = {}, {}
        for what, kw in (("meshless", {}), ("mesh", {"mesh": mesh})):
            pipe = StreamingPipeline(model.net, model.params, capacity=CAPACITY, streams=s,
                                     t_chunks=SERVE_CHUNKS, postprocess=post,
                                     max_in_flight=2, device=dev, **kw)
            sc.reset_launches()
            torch.cuda.synchronize()
            with k1_on_path() as seen:
                warm = list(pipe.serve(source[:s]))
            t1 = time.perf_counter()
            rest = list(pipe.serve(source[s:]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            got = pipe.gather_results(warm + rest)
            launches = dict(sc.LAUNCHES)
            require(launches == scan_launches(streams=SERVE_DISPATCHES),
                    f"{what} pipeline launches {launches}")
            check_k1_on_path(seen, f"{what} pipeline")
            served[what], pipes[what] = got, pipe
            info[what] = {"events_per_s": sum(r.n_events for r in rest) / wall,
                          "p50_ms": pipe.latency_stats()["dispatch_latency_ms"]["p50"],
                          "launches": launches}
        require(len(served["mesh"]) == len(served["meshless"]) == SERVE_DISPATCHES,
                "the mesh pipeline served another count of dispatches")
        for a, b in zip(served["mesh"], served["meshless"]):
            require(a.n_events == b.n_events and all(bit_equal(x, y) for x, y in
                                                     zip(a.outputs, b.outputs)),
                    "a mesh pipeline dispatch differs from the meshless one")
        require(bit_equal(pipes["mesh"].state[0].surface, pipes["meshless"].state[0].surface),
                "mesh pipeline end state differs")
        rows.append(f"StreamingPipeline(streams={s}) {SERVE_DISPATCHES} dispatches of "
                    f"{SERVE_CHUNKS} chunks, mesh against meshless: results and end state "
                    "bit-equal; events/s over dispatches 2.. "
                    f"{info['mesh']['events_per_s']:.0f} against "
                    f"{info['meshless']['events_per_s']:.0f}, p50 "
                    f"{info['mesh']['p50_ms']} against {info['meshless']['p50_ms']} ms, "
                    f"launches {info['mesh']['launches']} each")

        # -- Trainer(mesh) one step against the unsharded step
        net = EventNetwork(layer_defs, H, W, leak=args.leak, alpha=0.1,
                           padding=args.yolo_cnn_padding)
        frames, targets = train_batches(dev, args, np.random.RandomState(33), 1)[0]
        init = init_params(layer_defs)
        steps = []
        for m in (mesh, None):
            trainer = Trainer(net, TRAIN_CLASSES, num_bbox,
                              (args.yolo_num_cells_h, args.yolo_num_cells_w), mesh=m)
            p = params_from_jax(init, dev)
            p, _, loss = trainer.step(p, trainer.init(p), frames, targets)
            steps.append((loss, p))
        (loss_m, p_m), (loss_r, p_r) = steps
        require(bit_equal(loss_m, loss_r) and all(bit_equal(p_m[k].detach(), p_r[k].detach())
                                                  for k in p_r),
                "Trainer(mesh) step differs from Trainer(mesh=None)")
        rows.append(f"Trainer(mesh) one step at batch {TRAIN_BATCH}: loss {float(loss_m):.6f} "
                    "and every parameter bit-equal to Trainer(mesh=None)")
    require(not dist.is_initialized(), "the one-card world outlived its phase")
    print(f"mesh: an NCCL world of 1 on the card (started in {info['start_ms']:.1f} ms), "
          f"eFCN {H}x{W} at 'highest': " + "; ".join(rows) + f"; card {smi!r}", flush=True)
    return info


def make_stream_chunks(rng, t, dev):
    """``t`` chunks of a clustered stream (phase 8's) on ``dev``."""
    from async_ev_cnn_torch.utils.runner import pack_chunks

    return pack_chunks(clustered_stream(rng, t, CAPACITY), CAPACITY, device=dev)


def mesh_rank(chunks, cfg, device):
    """One rank of phase 31: the network of config ``cfg`` with the seeded
    weights on ``device``, MultiStreamEngine.scan_parallel over a
    world-sized data axis on the global ``[T, S, E]`` chunks (numpy
    planes), once to set cuDNN up, once counted (its K1 call held
    bit-equal to its plain version on the same inputs) and once timed (to
    its outputs on the host); returns the rank's K1 counts and
    call's shape, its wall ms and (rank 0) the gathered outputs."""
    import torch.distributed as dist

    from async_ev_cnn_torch.layers.types import EventChunk
    from async_ev_cnn_torch.models.yolo import YoloEventTorch
    from async_ev_cnn_torch.ops import surface_scan as sc
    from async_ev_cnn_torch.parallel import MultiStreamEngine, make_mesh
    from async_ev_cnn_torch.parallel.mesh import mesh_device
    from async_ev_cnn_torch.utils.config import config

    args = config(["-c", cfg])
    layer_defs = args.yolo_cnn_layers
    num_bbox = args.yolo_num_bbox
    num_classes = list(layer_defs.values())[-1][3] - num_bbox * 5
    mesh = make_mesh(dist.get_world_size(), 1, device=device)
    model = YoloEventTorch(
        args.frame_h, args.frame_w, num_classes, layer_defs, args.yolo_cnn_padding,
        args.yolo_num_cells_h, args.yolo_num_cells_w, num_bbox, alpha=0.1,
        leak=args.leak, conv_mode="full", device=mesh_device(mesh))
    model.set_weights(make_params(layer_defs, np.random.RandomState(0)))
    eng = MultiStreamEngine(model.net, mesh)
    chunks = EventChunk(*(torch.from_numpy(a) for a in chunks))
    params = eng.place_params(model.params)
    states = eng.init_states(model.params, chunks.y.shape[1])
    local = eng.place_chunks(chunks, leading_time=True)
    eng.scan_parallel(params, states, local)[1].cpu()  # cuDNN set-up
    sc.reset_launches()
    with k1_on_path() as seen:
        _, outs = eng.scan_parallel(params, states, local)
        outs = outs.cpu()
    launches = dict(sc.LAUNCHES)
    k1_shape = check_k1_on_path(seen, f"rank {dist.get_rank()}'s scan_parallel")
    t0 = time.perf_counter()
    eng.scan_parallel(params, states, local)[1].cpu()  # waits for the card
    ms = (time.perf_counter() - t0) * 1e3
    outs = eng.gather(outs)  # gloo: through the host
    return {"launches": launches, "k1_shape": k1_shape, "ms": ms, "staged": eng.data.staged,
            "outs": outs.cpu().numpy() if dist.get_rank() == 0 else None}


def ranks_phase(mesh_info, smi, cfg=str(HERE / "configs" / "efcn_event.yml"),
                device="cuda"):
    """Phase 31: MESH_RANKS gloo ranks on the one card (NCCL takes one
    rank a card): the port's dry run (every leg within 1e-5 of the
    unsharded path), then the full-width MultiStreamEngine.scan_parallel on
    a MESH_RANKS x 1 mesh, MESH_STREAMS / MESH_RANKS streams a rank, its
    gathered outputs within MESH_TOL of phase 30's one-process call, each
    rank's K1 counted (one call) and held bit-equal to its plain version in
    the rank."""
    from async_ev_cnn_torch.parallel.dryrun import dryrun_multichip
    from async_ev_cnn_torch.parallel.launch import launch

    with contextlib.redirect_stdout(io.StringIO()):
        dry = dryrun_multichip(MESH_RANKS, device)
    chunks = tuple(f.numpy() for f in mesh_info["chunks"])
    t0 = time.perf_counter()
    ranks = launch(mesh_rank, MESH_RANKS, args=(chunks, cfg, device), backend="gloo",
                   timeout=600)
    wall = time.perf_counter() - t0
    for r, got in enumerate(ranks):
        require(got["launches"] == scan_launches(streams=1)
                and got["staged"] == (device == "cuda"),
                f"rank {r}: launches {got['launches']}, staged {got['staged']}")
    err = float(np.abs(ranks[0]["outs"] - mesh_info["outs"].numpy()).max())
    require(err <= MESH_TOL, f"{MESH_RANKS} ranks' outputs {err} from the one-process call")
    rank_ms = ", ".join(f"{g['ms']:.1f}" for g in ranks)
    print(f"ranks: {MESH_RANKS} gloo ranks on {device} (collectives through the host); "
          f"dryrun_multichip({MESH_RANKS}) "
          + ", ".join(f"leg {k} {v:.3e}" for k, v in dry["errors"].items())
          + f" in {dry['seconds']:.1f} s; MultiStreamEngine.scan_parallel on a "
          f"{MESH_RANKS}x1 mesh, {MESH_STREAMS // MESH_RANKS} streams a rank x "
          f"{MESH_CHUNKS} chunks: gathered outputs within {err:.3e} of phase 30's "
          f"one-process S={MESH_STREAMS} call, K1 launches a rank "
          f"{[g['launches']['surface_scan_events_streams'] for g in ranks]}, each "
          f"rank's K1 call ({ranks[0]['k1_shape']}) bit-equal to its plain version, a "
          "rank's call "
          f"{rank_ms} ms (spawn to results {wall:.1f} s); card {smi!r}", flush=True)
    return {"dry": dry, "err": err, "launches": [g["launches"] for g in ranks]}


# ---- phases 32-33: Orbax checkpoints and the ranks CLI -------------------------

RANKS_CLI = 2


def orbax_phase(model, kwargs, items, smi):
    """Phase 32: with tensorstore, the seeded eFCN weights written by the
    port's save_params_orbax and read back by load_params bit-equal (both
    timed); then DISPATCHES dispatches of phase 4's stream served by
    StreamingPipeline from ``YoloEventTorch(checkpoint=orbax_dir)`` (K1
    counted, its first call bit-equal to its plain version), bit-equal to
    the same dispatches from the .npz-loaded model.  Without tensorstore,
    load_params on a directory holding ``_METADATA`` must raise the
    NotImplementedError that names it (a reported fact, not a caught
    failure)."""
    import tempfile

    from async_ev_cnn_torch.models.yolo import YoloEventTorch
    from async_ev_cnn_torch.ops import surface_scan as sc
    from async_ev_cnn_torch.utils.checkpoint import load_params, save_params, save_params_orbax
    from async_ev_cnn_torch.utils.serving import StreamingPipeline

    try:
        import tensorstore  # noqa: F401
    except ImportError:
        with tempfile.TemporaryDirectory() as tmp:
            (Path(tmp) / "_METADATA").write_text("{}")
            try:
                load_params(tmp)
            except NotImplementedError as err:
                require("tensorstore" in str(err), f"the Orbax refusal names no package: {err}")
            else:
                require(False, "an Orbax directory loaded without tensorstore")
        print(f"orbax: tensorstore absent, refused; card {smi!r}", flush=True)
        return None
    weights = make_params(kwargs["cnn_layers"], np.random.RandomState(0))
    with tempfile.TemporaryDirectory() as tmp:
        orbax_dir, npz = str(Path(tmp) / "efcn_orbax"), str(Path(tmp) / "efcn.npz")
        t0 = time.perf_counter()
        save_params_orbax(orbax_dir, weights)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        loaded = load_params(orbax_dir)
        load_ms = (time.perf_counter() - t0) * 1e3
        require(sorted(loaded) == sorted(weights) and all(
            loaded[k].dtype == v.dtype and loaded[k].shape == v.shape
            and np.array_equal(loaded[k].view(np.int32), v.view(np.int32))
            for k, v in weights.items()), "the Orbax round trip changed the weights")
        save_params(npz, weights)
        models = {fmt: YoloEventTorch(**kwargs, conv_mode="full", checkpoint=path)
                  for fmt, path in (("orbax", orbax_dir), ("npz", npz))}
    served, launches = {}, {}
    for fmt, m in models.items():
        pipe = StreamingPipeline(m.net, m.params, capacity=CAPACITY, t_chunks=T_CHUNKS,
                                 wire="plain", max_in_flight=2, device=model.device)
        sc.reset_launches()
        with k1_on_path() as seen:
            served[fmt] = [r.outputs for r in pipe.serve(items[:DISPATCHES])]
            torch.cuda.synchronize()
        launches[fmt] = dict(sc.LAUNCHES)
        k1_shape = check_k1_on_path(seen, f"the {fmt}-loaded pipeline")
        # one stream on the card: K1 through its wrapper in the eager
        # dispatches and the captures, a replay's inside its graph
        made = pipe.stats["eager_dispatches"] + pipe.stats["graph_captures"]
        require(launches[fmt] == scan_launches(events=made)
                and pipe.stats["eager_dispatches"] + pipe.stats["graph_replays"] == DISPATCHES,
                f"the {fmt}-loaded pipeline launched {launches[fmt]} on {DISPATCHES} "
                f"dispatches, {pipe.stats}")
    require(all(bit_equal(a, b) for a, b in zip(served["orbax"], served["npz"])),
            "the Orbax-loaded model serves other grids than the .npz-loaded one")
    print(f"orbax: seeded eFCN weights ({sum(v.nbytes for v in weights.values())} bytes) "
          f"written by save_params_orbax (tensorstore, zarr on OCDBT) in {save_ms:.1f} ms, "
          f"read by load_params in {load_ms:.1f} ms, bit-equal; {DISPATCHES} dispatches of "
          f"phase 4's stream from YoloEventTorch(checkpoint=orbax_dir) bit-equal to the "
          f".npz-loaded model's, launches {launches['orbax']}, the first K1 call ({k1_shape}) "
          f"bit-equal to its plain version; card {smi!r}", flush=True)
    return {"save_ms": save_ms, "load_ms": load_ms}


def cli_rank(argv):
    """One NCCL rank of phase 33 (two cards or more): the rank side of
    ``run_networks --num_ranks`` (``run_networks._rank_main``) with K1
    counted and its first call held bit-equal to its plain version in the
    rank; the rank's stats, K1 counts and card."""
    from async_ev_cnn_torch.ops import surface_scan as sc
    from async_ev_cnn_torch.scripts import run_networks

    sc.reset_launches()
    with k1_on_path() as seen:
        stats = run_networks._rank_main(argv)
    launches = dict(sc.LAUNCHES)
    shape = check_k1_on_path(seen, "a rank of run_networks --num_ranks")
    return {"stats": stats, "launches": launches, "k1_shape": shape,
            "card": torch.cuda.current_device()}


def ranks_cli_phase(dev, smi):
    """Phase 33: ``run_networks --num_streams 2 --num_ranks 2`` on
    configs/efcn_event_full.yml over phase 25's tree writer (CLI_EXAMPLES
    test examples) with seeded weights.  With one card: on cuda it is
    refused before any rank starts (the error names --device cpu), and
    with --device cpu it finishes on two gloo ranks.  With two cards or
    more: two NCCL ranks, a card each, through the CLI (rank 0's stats),
    then the same rank side launched here with K1 counted and held in
    each rank.  Wall times printed."""
    import tempfile

    from async_ev_cnn_torch.parallel import launch as launch_mod
    from async_ev_cnn_torch.scripts import run_networks
    from async_ev_cnn_torch.utils.checkpoint import save_params
    from async_ev_cnn_torch.utils.config import config

    full_cfg = str(HERE / "configs" / "efcn_event_full.yml")
    args = config(["-c", full_cfg])
    layer_defs = args.yolo_cnn_layers
    num_classes = list(layer_defs.values())[-1][3] - args.yolo_num_bbox * 5
    cards = torch.cuda.device_count()

    def run(argv):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            stats = run_networks.main(argv)
        secs = time.perf_counter() - t0
        require(json.loads(out.getvalue().strip().splitlines()[-1]) == stats
                and stats["examples"] == CLI_EXAMPLES and stats["events_per_sec"] > 0,
                f"run_networks {' '.join(argv[-4:])}: {stats}")
        return stats, secs

    with tempfile.TemporaryDirectory() as tmp:
        tree, weights = Path(tmp) / "tree", str(Path(tmp) / "efcn.npz")
        write_detection_tree(tree, np.random.RandomState(33), num_classes, args)
        save_params(weights, make_params(layer_defs, np.random.RandomState(0)))
        argv = ["-c", full_cfg, "--input_data_dir", str(tree), "--restore_net", weights,
                "--num_streams", "2", "--num_ranks", str(RANKS_CLI)]
        rows = []
        if cards < RANKS_CLI:
            spawned = []
            real = launch_mod.mp.start_processes
            launch_mod.mp.start_processes = lambda *a, **k: spawned.append(a) or real(*a, **k)
            t0 = time.perf_counter()
            try:
                run_networks.main(argv)
            except ValueError as err:
                refusal = str(err)
            else:
                refusal = None
            finally:
                launch_mod.mp.start_processes = real
            refused_s = time.perf_counter() - t0
            require(refusal is not None and "--device cpu" in refusal and not spawned,
                    f"--num_ranks {RANKS_CLI} on {cards} card(s): refusal {refusal!r}, "
                    f"{len(spawned)} launch(es)")
            rows.append(f"on cuda refused before any rank started in {refused_s:.2f} s: "
                        f"{refusal!r}")
            stats, secs = run(argv + ["--device", "cpu"])
            rows.append(f"--device cpu: {RANKS_CLI} gloo ranks, rank 0's stats "
                        f"{json.dumps(stats)} in {secs:.2f} s (spawn to results)")
        else:
            stats, secs = run(argv)
            rows.append(f"{RANKS_CLI} NCCL ranks through the CLI, a card each: rank 0's "
                        f"stats {json.dumps(stats)} in {secs:.2f} s (spawn to results)")
            t0 = time.perf_counter()
            ranks = launch_mod.launch(cli_rank, RANKS_CLI, args=(argv,), backend="nccl",
                                      timeout=None)
            secs = time.perf_counter() - t0
            for r, got in enumerate(ranks):
                require(got["card"] == r and got["stats"]["examples"] == CLI_EXAMPLES
                        and got["launches"] == scan_launches(streams=CLI_EXAMPLES // 2),
                        f"rank {r}: card {got['card']}, launches {got['launches']}, "
                        f"stats {got['stats']}")
            rows.append(f"the rank side launched here: ranks on cards "
                        f"{[g['card'] for g in ranks]}, K1 launches "
                        f"{[g['launches'] for g in ranks]}, each rank's first K1 call "
                        f"({ranks[0]['k1_shape']}) bit-equal to its plain version, "
                        f"{secs:.2f} s")
    print(f"ranks-cli: run_networks -c efcn_event_full.yml --num_streams 2 --num_ranks "
          f"{RANKS_CLI} over {CLI_EXAMPLES} examples of {CLI_EVENTS} events with {cards} "
          "card(s): " + "; ".join(rows) + f"; card {smi!r}", flush=True)
    return rows


# ---- phase 34: the window memory model on the card -----------------------------

# tests/test_memory_model.py's off-calibration geometries (T = 24 chunks of
# 16 events), then the eFCN of configs/efcn_event.yml at the main path's T
MEM_GEOMETRIES = (
    ("thin_stem_64x96", "conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,8", 64, 96, 24, 16),
    ("deep_32x48", "conv1=3,3,1,8 pool1=2,2 conv2=3,3,8,16 pool2=2,2 conv3=3,3,16,32 "
     "pool3=2,2 conv4=1,1,32,16", 32, 48, 24, 16),
    ("polarity_48x48", "conv1=3,3,2,8 pool1=2,2 conv2=1,1,8,12", 48, 48, 24, 16),
)
MEM_BUDGETS_MB = (256, 1024)
# the model against the measured peak without outputs, as the JAX test holds
# it against XLA's temp_size: the 2x-safe budget covers it, and the model is
# not so loose that windows collapse
MEM_SLACK = 30


def peak_bytes(fn):
    """``fn()``'s peak device bytes above what was allocated before it, and
    the bytes of what it returns (allocated after it, above before): the
    peak with outputs and, minus the second, without them."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    result = fn()
    torch.cuda.synchronize()
    return result, torch.cuda.max_memory_allocated() - base, \
        torch.cuda.memory_allocated() - base


def memory_model_phase(dev, smi):
    """Phase 34: EventNetwork.parallel_live_bytes_per_chunk and auto_window
    against the card's own peak (torch.cuda.max_memory_allocated above the
    bytes allocated before one scan_parallel call), at
    tests/test_memory_model.py's three geometries and the eFCN (T=200
    chunks of 256 events): 2 * model * T covers the peak without outputs
    (XLA's temp_size in the JAX test), model * T is at most MEM_SLACK
    times it, and at the eFCN scan_parallel(window=auto_window(T, B))
    stays within B MB for each budget of MEM_BUDGETS_MB, its grids within
    OUT_TOL of the unwindowed call's and its end surface bit-equal.  Each
    call is measured twice (the first sets cuDNN up) and the larger peak
    kept."""
    from async_ev_cnn_torch.layers.network import EventNetwork
    from async_ev_cnn_torch.utils.config import config, layers_dict
    from async_ev_cnn_torch.utils.runner import pack_chunks
    from async_ev_cnn_torch.utils.weights import params_from_jax

    efcn = config(["-c", str(HERE / "configs" / "efcn_event.yml")]).yolo_cnn_layers
    geoms = [(name, layers_dict(dsl), h, w, t, cap)
             for name, dsl, h, w, t, cap in MEM_GEOMETRIES]
    geoms.append(("efcn_160x224", efcn, H, W, T_CHUNKS, CAPACITY))
    rows, failed = [], []
    for name, layer_defs, h, w, t, cap in geoms:
        rng = np.random.RandomState(34)
        net = EventNetwork(layer_defs, h, w, leak=1e-4, alpha=0.1, padding="SAME",
                           conv_mode="full")
        params = params_from_jax(make_params(layer_defs, rng), dev)
        state = net.init_state(params, dev)
        n = t * cap
        cols = [rng.randint(0, h, n), rng.randint(0, w, n), np.sort(rng.randint(1, 5000, n))]
        if net.event_layers[0].spec.channels == 2:
            cols.append(rng.randint(0, 2, n))
        chunks = pack_chunks(np.stack(cols, axis=-1).astype(np.int32), cap, device=dev)
        runs = [peak_bytes(lambda: net.scan_parallel(params, state, chunks)) for _ in range(2)]
        (st_all, out_all), _, out_bytes = runs[0]
        peak = max(r[1] for r in runs)
        temp = peak - out_bytes
        model = net.parallel_live_bytes_per_chunk()
        row = (f"{name} T={t} E={cap}: model {model} B/chunk x {t} = {model * t} B, peak "
               f"{peak} B with outputs ({runs[0][1]} first call, {runs[1][1]} second), "
               f"{temp} B without, 2*model*T/peak {2 * model * t / temp:.3f}, "
               f"model*T/peak {model * t / temp:.3f}")
        if 2 * model * t < temp:
            failed.append(f"{name}: 2 * model * T = {2 * model * t} B < measured {temp} B")
        if model * t > MEM_SLACK * temp:
            failed.append(f"{name}: model * T = {model * t} B > {MEM_SLACK} x {temp} B")
        if t == T_CHUNKS:
            for budget in MEM_BUDGETS_MB:
                win = net.auto_window(t, budget)
                runs = [peak_bytes(lambda: net.scan_parallel(params, state, chunks, window=win))
                        for _ in range(2)]
                (st_w, out_w), _, _ = runs[0]
                win_peak = max(r[1] for r in runs)
                err = float((out_w - out_all).abs().max())
                row += (f"; budget {budget} MB: window {win}, peak {win_peak} B "
                        f"({win_peak / 2**20:.2f} MB), grids within {err:.2e}")
                if win_peak > budget * 2**20:
                    failed.append(f"{name}: window {win} of budget {budget} MB peaks at "
                                  f"{win_peak / 2**20:.2f} MB")
                require(err <= OUT_TOL and bit_equal(st_w[0].surface, st_all[0].surface),
                        f"{name}: the window of {budget} MB changes the result ({err})")
        rows.append(row)
        del net, params, state, chunks, runs, st_all, out_all
    print("memory-model: EventNetwork.scan_parallel's peak on the card "
          "(max_memory_allocated above the bytes before the call) against "
          "parallel_live_bytes_per_chunk and auto_window: " + "; ".join(rows)
          + f"; card {smi!r}", flush=True)
    require(not failed, "the window memory model under-counts the card: " + "; ".join(failed))
    return rows


# ---- phase 37: RVT-B's kernels and its served path ----------------------------

RVT_H, RVT_W = 384, 640
RVT_YAML = "async_ev_cnn_torch/configs/rvt_base_event.yml"
# the rvt_base_full.replay_s16 cell's dispatch: 16 streams x 64 chunks of 200
# clustered events, 1,024 frames
RVT_STREAMS, RVT_CHUNKS, RVT_EVENTS = 16, 64, 200
RVT_FRAMES = RVT_STREAMS * RVT_CHUNKS
# a dispatch's E1 launches: SiLU in the four CSP layers (7 convs each), the
# PAFPN's two lateral and two bottom-up convs and 5 a head level; the linear
# box, objectness and class convs of the three levels
RVT_SILUS, RVT_LINEARS = 4 * 7 + 4 + 3 * 5, 3 * 3
# L1, G1 and E1's SiLU form against their plain versions: within this share
# of the plain version's largest value (tests/test_torch_rvt_chip.py's)
RVT_KERNEL_REL = 1e-6
# one stream's 64 chunks under this window budget: auto_window's window
# must keep the call's peak inside it
RVT_BUDGET_MB = 2000


def rvt_stages(net):
    """(C, H, W) of each attention pair's and LSTM's maps, in order."""
    return [ld.spec.in_shape for ld in net.event_layers[1:] if ld.kind == "attn"]


def rvt_kernel_row(what, calls, got, want, ms, n_bytes, exact=False):
    """One case of phase 37: ``got`` within RVT_KERNEL_REL of ``want``'s
    largest value (equal where ``exact``), its device ms a call and its
    bound (bytes at PEAK_BYTES_S), and ``calls`` a dispatch."""
    torch.cuda.synchronize()
    gap = float((got.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    require(got.shape == want.shape and (torch.equal(got, want) if exact
                                         else gap <= RVT_KERNEL_REL * top),
            f"{what}: {gap:.3g} from its plain version, whose largest value is {top:.3g}")
    return {"case": what, "calls": calls, "max_abs_err": gap, "ms": ms,
            "bound_ms": bound_ms(n_bytes, 0)[0]}


def rvt_kernel_cases(dev, net):
    """L1 (every call of a dispatch's walk: the four embeddings' channels-
    first maps over all RVT_FRAMES frames, and each pair's three kinds of
    call at its block of frames), G1 (a step of each LSTM: the 16 streams'
    pixels) and E1's SiLU form (each shape of the dispatch's SiLU convs)
    at the path's shapes against their plain versions, with device ms a
    call and bound.  Returns each kernel's rows."""
    from async_ev_cnn_torch.ops import epilogue as ep
    from async_ev_cnn_torch.ops import layer_norm as l1
    from async_ev_cnn_torch.ops import lstm_gates as g1
    from async_ev_cnn_torch.ops import rvt

    g = torch.Generator(device=dev).manual_seed(37)
    rows = {"layer_norm": [], "lstm_gates": [], "conv_epilogue_silu": []}
    ph, pw = next(ld.spec.partition for ld in net.event_layers if ld.kind == "attn")
    for c, h, w in rvt_stages(net):
        gamma = torch.rand(c, generator=g, device=dev) + 0.5
        beta = torch.randn(c, generator=g, device=dev) * 0.1
        # the embedding: the strided conv's NCHW map, read through its view
        x = torch.randn(RVT_FRAMES, c, h, w, generator=g, device=dev).permute(0, 2, 3, 1)
        n_bytes = 8 * x.numel()
        rows["layer_norm"].append(rvt_kernel_row(
            f"embedding C={c} {h}x{w} channels-first N={RVT_FRAMES}", 1,
            l1.layer_norm(x, gamma, beta, rvt.LN_EPS),
            l1.layer_norm_plain(x, gamma, beta, rvt.LN_EPS),
            device_ms(lambda: l1.layer_norm(x, gamma, beta, rvt.LN_EPS), "layer_norm_kernel"),
            n_bytes))
        del x
        # a pair's block: the window half's partition alone (after an
        # embedding), the grid half's pre-norm, the two MLPs' norms
        step = max(1, rvt.ATTN_BLOCK_TOKENS // (h * w))
        n = min(step, RVT_FRAMES)
        blocks = -(-RVT_FRAMES // step)
        x = torch.randn(n, h, w, c, generator=g, device=dev)
        for kind, norm, calls in (("win", False, 1), ("grid", True, 1), (None, True, 2)):
            args = (x, gamma if norm else None, beta if norm else None, rvt.LN_EPS, kind, ph, pw)
            rows["layer_norm"].append(rvt_kernel_row(
                f"pair C={c} {h}x{w} {kind or 'tokens'}{'' if norm else ' (copy)'} N={n}",
                calls * blocks, l1.layer_norm(*args), l1.layer_norm_plain(*args),
                device_ms(lambda: l1.layer_norm(*args), "layer_norm_kernel"),
                8 * x.numel(), exact=not norm))
        del x
        # a step of the LSTM: the streams' pixels, 4C gates a pixel
        r = RVT_STREAMS * h * w
        gates = torch.randn(r, 4 * c, generator=g, device=dev) * 3
        cell = torch.randn(r, c, generator=g, device=dev) * 2
        want_c, want_h = cell.clone(), torch.empty_like(cell)
        g1.lstm_gates_plain(gates.clone(), want_c, want_h)
        got_c, got_h = cell.clone(), torch.empty_like(cell)
        g1.lstm_gates(gates.clone(), got_c, got_h)
        row = rvt_kernel_row(f"step C={c} R={r}", RVT_CHUNKS, torch.cat([got_c, got_h]),
                             torch.cat([want_c, want_h]),
                             device_ms(lambda: g1.lstm_gates(gates, cell, got_h),
                                       "lstm_gates_kernel"), 4 * 7 * r * c)
        rows["lstm_gates"].append(row)
        del gates, cell, want_c, want_h, got_c, got_h
        torch.cuda.empty_cache()
    # E1's SiLU form at each shape of the dispatch's SiLU convs
    shapes = {}
    for ld in net.event_layers[1:]:
        convs = ld.spec.convs.values() if ld.kind == "csp" else (
            (ld.spec,) if getattr(ld.spec, "act", None) == "silu" else ())
        for spec in convs:
            key = tuple(spec.out_shape)
            shapes[key] = shapes.get(key, 0) + 1
    require(sum(shapes.values()) == RVT_SILUS,
            f"RVT-B's walk has {sum(shapes.values())} SiLU convs, not {RVT_SILUS}")
    for (c, h, w), calls in sorted(shapes.items()):
        raw = torch.randn(RVT_FRAMES, c, h, w, generator=g, device=dev) * 2
        bias = torch.randn(c, generator=g, device=dev) * 0.3
        rows["conv_epilogue_silu"].append(rvt_kernel_row(
            f"C={c} {h}x{w} N={RVT_FRAMES}", calls,
            ep.conv_epilogue(raw, bias, 0.1, act="silu"),
            ep.conv_epilogue_plain(raw.clone(), bias, 0.1, act="silu"),
            device_ms(lambda: ep.conv_epilogue(raw, bias, 0.1, act="silu"),
                      "act_epilogue_kernel"), 8 * raw.numel()))
        del raw
        torch.cuda.empty_cache()
    return rows


def rvt_net(dev):
    """RVT-B from its configuration at 384x640, with the reference's seeded
    weights (reference/rvt.make_weights), batch norm folded."""
    from async_ev_cnn_torch.layers.network import EventNetwork
    from async_ev_cnn_torch.utils.config import layers_dict
    from async_ev_cnn_torch.utils.weights import fold_batchnorm
    from reference import rvt as ref

    text = (HERE / RVT_YAML).read_text().split("yolo_cnn_layers: ")[1].split("\n")[0]
    net = EventNetwork(layers_dict(text), RVT_H, RVT_W, LEAK, 0.1, "SAME", conv_mode="full",
                       stem_fusion=False)
    wt = ref.make_weights(ref.architecture(), 2024, dev)
    return net, fold_batchnorm(wt, eps=ref.BN_EPS, form="torch")


def rvt_path(dev, net, params):
    """RVT-B served by StreamingPipeline as the cell serves it (16 streams
    x 64 chunks of 200 clustered events a dispatch, YOLOX's decode on the
    card): a first dispatch (cuDNN times its convs' algorithms), then one
    with the counts set to 0 just before it and read just after, then one
    under torch.profiler.  Returns the counted dispatch's launches, its
    peak bytes and the profiled dispatch's device ms by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from async_ev_cnn_torch.layers.types import LstmState
    from async_ev_cnn_torch.models.head import decode_yolox
    from async_ev_cnn_torch.ops import epilogue as ep
    from async_ev_cnn_torch.ops import layer_norm as l1
    from async_ev_cnn_torch.ops import lstm_gates as g1
    from async_ev_cnn_torch.ops import surface_scan as sc
    from async_ev_cnn_torch.utils.serving import StreamingPipeline

    def post(outs):
        boxes, _, probs = decode_yolox(outs, net.head_strides)
        return boxes, probs

    pipe = StreamingPipeline(net, params, capacity=RVT_EVENTS, streams=RVT_STREAMS,
                             t_chunks=RVT_CHUNKS, max_in_flight=2, postprocess=post,
                             device=dev)
    rng = np.random.RandomState(37)
    streams = [clustered_stream(rng, 3 * RVT_CHUNKS, RVT_EVENTS, h=RVT_H, w=RVT_W)
               for _ in range(RVT_STREAMS)]
    items = [[s[k * RVT_CHUNKS * RVT_EVENTS:(k + 1) * RVT_CHUNKS * RVT_EVENTS] for s in streams]
             for k in range(3)]
    list(pipe.serve(items[0]))
    torch.cuda.synchronize()
    for mod in (l1, g1, ep, sc):
        mod.LAUNCHES.update(dict.fromkeys(mod.LAUNCHES, 0))
    net.reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    (r,) = pipe.serve(items[1])
    torch.cuda.synchronize()
    launches = {"layer_norm": l1.LAUNCHES["layer_norm"], "lstm_gates": g1.LAUNCHES["lstm_gates"],
                "conv_epilogue": ep.LAUNCHES["conv_epilogue"],
                "conv_epilogue_silu": ep.LAUNCHES["conv_epilogue_silu"],
                "surface_scan_events_streams": sc.LAUNCHES["surface_scan_events_streams"],
                "recurrent_steps": sum(c["recurrent_steps"] for c in net.layer_counts.values())}
    peak = torch.cuda.max_memory_allocated(dev) - before
    boxes, probs = r.outputs
    require(r.n_events == RVT_FRAMES * RVT_EVENTS, f"the dispatch consumed {r.n_events} events")
    require(boxes.shape[:2] == probs.shape[:2] == (RVT_STREAMS, RVT_CHUNKS)
            and bool(torch.isfinite(boxes).all() and torch.isfinite(probs).all()),
            f"RVT-B's decoded outputs {tuple(boxes.shape)}, {tuple(probs.shape)}")
    lstm = [s for s in pipe.state if isinstance(s, LstmState)]
    require(len(lstm) == 4 and all(bool(s.c.abs().max() > 0) for s in lstm),
            "the pipeline carries no LSTM state")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        list(pipe.serve(items[2]))
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = ("layer_norm" if "layer_norm_kernel" in e.name else
                "lstm_gates" if "lstm_gates_kernel" in e.name else
                "conv_epilogue_silu" if "act_epilogue_kernel<" in e.name
                and e.name.split("<")[1].split(",")[1].strip() == "true" else "other")
        ms, n = by.get(name, (0.0, 0))
        by[name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return launches, peak, by


def rvt_memory(dev, net, params):
    """One stream's RVT_CHUNKS chunks through scan_parallel, whole and with
    window_budget_mb=RVT_BUDGET_MB: the windowed call's peak above the
    bytes before it must lie inside the budget, the whole call's inside the
    model (2x the per-chunk maps and the transient blocks)."""
    from async_ev_cnn_torch.utils.runner import pack_chunks

    stream = clustered_stream(np.random.RandomState(38), RVT_CHUNKS, RVT_EVENTS, h=RVT_H,
                              w=RVT_W)
    chunks = pack_chunks(stream, RVT_EVENTS, device=dev)
    state = net.init_state(params, dev)
    out = {}
    for budget in (None, RVT_BUDGET_MB):
        def call(budget=budget):
            return net.scan_parallel(params, state, chunks, window_budget_mb=budget)
        call()
        torch.cuda.synchronize()
        out[budget] = peak_bytes(call)[1]
    model = (2 * net.parallel_live_bytes_per_chunk() * RVT_CHUNKS
             + net.parallel_transient_bytes(RVT_CHUNKS))
    window = net.auto_window(RVT_CHUNKS, RVT_BUDGET_MB)
    require(out[RVT_BUDGET_MB] <= RVT_BUDGET_MB * 2**20,
            f"window {window} under a {RVT_BUDGET_MB} MB budget peaked at "
            f"{out[RVT_BUDGET_MB] / 2**20:.1f} MB")
    require(out[None] <= model, f"one stream's {RVT_CHUNKS} chunks peaked at {out[None]} "
            f"bytes, above the model's {model}")
    return {"window": window, "peak_mb": out[RVT_BUDGET_MB] / 2**20,
            "whole_peak_mb": out[None] / 2**20, "model_mb": model / 2**20}


def rvt_phase(dev, smi):
    """Phase 37: RVT-B (configs/rvt_base_event.yml) at 384x640.  L1, G1 and
    E1's SiLU form against their plain versions at every shape of a
    dispatch's walk (:func:`rvt_kernel_cases`); the served path
    (:func:`rvt_path`) with exact launch counts: L1 4 + 4 a pair a block of
    frames, G1 4 LSTMs x 64 steps, E1 RVT_SILUS SiLU and RVT_LINEARS
    linear, one K1, 256 recurrent steps, its peak inside the memory model
    at 1,024 frames; the window budget on the card (:func:`rvt_memory`).
    Returns L1's, G1's and the SiLU form's entries of the kernels' line."""
    from async_ev_cnn_torch.ops import rvt

    net, params = rvt_net(dev)
    cases = rvt_kernel_cases(dev, net)
    blocks = sum(-(-RVT_FRAMES // max(1, rvt.ATTN_BLOCK_TOKENS // (h * w)))
                 for _, h, w in rvt_stages(net))
    want = {"layer_norm": 4 + 4 * blocks, "lstm_gates": 4 * RVT_CHUNKS,
            "conv_epilogue": RVT_SILUS + RVT_LINEARS, "conv_epilogue_silu": RVT_SILUS,
            "surface_scan_events_streams": 1, "recurrent_steps": 4 * RVT_CHUNKS}
    launches, peak, by = rvt_path(dev, net, params)
    require(launches == want, f"RVT-B's dispatch launched {launches}, not {want}")
    model = (2 * net.parallel_live_bytes_per_chunk() * RVT_FRAMES
             + net.parallel_transient_bytes(RVT_FRAMES))
    require(peak <= model, f"RVT-B's dispatch peaked at {peak} bytes, above the model's {model}")
    mem = rvt_memory(dev, net, params)
    entries = []
    sources = {"layer_norm": "layer_norm.cu", "lstm_gates": "lstm_gates.cu",
               "conv_epilogue_silu": "conv_epilogue.cu"}
    for name, rows in cases.items():
        per = {k: sum(r[k] * r["calls"] for r in rows) for k in ("ms", "bound_ms")}
        require(sum(r["calls"] for r in rows) == want[name],
                f"{name}'s cases cover {sum(r['calls'] for r in rows)} calls of {want[name]}")
        entries.append({"name": name, "route": "cuda",
                        "source": f"async_ev_cnn_torch/csrc/{sources[name]}", "replaces": None,
                        "launches": launches[name],
                        "max_abs_err": max(r["max_abs_err"] for r in rows),
                        "ms": per["ms"], "bound_ms": per["bound_ms"], "bound_by": "bytes",
                        "path_ms": by.get(name, (None, 0))[0],
                        "path_records": by.get(name, (0.0, 0))[1], "library_ms": None,
                        "cases": rows})
    print(f"rvt: RVT-B {RVT_H}x{RVT_W} at its published widths; L1, G1 and E1's SiLU form "
          f"within {RVT_KERNEL_REL} of their plain versions' largest values (L1's partitions "
          f"alone equal) at every shape of a dispatch's walk; a dispatch ({RVT_STREAMS} streams "
          f"x {RVT_CHUNKS} chunks of {RVT_EVENTS} clustered events) through StreamingPipeline: "
          f"launches {launches}, peak {peak / 2**30:.2f} GiB (model {model / 2**30:.2f}); "
          "device ms a dispatch from the cases (bound, share of it; in the profiled dispatch): "
          + "; ".join(f"{e['name']} {e['ms']:.3f} ({e['bound_ms']:.3f}, "
                      f"{100 * e['bound_ms'] / e['ms']:.1f}%; {e['path_ms'] or 0.0:.3f} ms in "
                      f"{e['path_records']} records)"
                      for e in entries)
          + f"; the rest of the dispatch {by.get('other', (0.0, 0))[0]:.1f} ms; one stream's "
          f"{RVT_CHUNKS} chunks under a {RVT_BUDGET_MB} MB budget: window {mem['window']}, "
          f"peak {mem['peak_mb']:.1f} MB (whole: {mem['whole_peak_mb']:.1f} MB, model "
          f"{mem['model_mb']:.1f}); card {smi!r}", flush=True)
    del net, params
    torch.cuda.empty_cache()
    return entries


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
    from async_ev_cnn_torch.layers import conv_stack
    from async_ev_cnn_torch.ops import conv_pool as tcp
    from async_ev_cnn_torch.ops import epilogue as ep
    from async_ev_cnn_torch.ops import fused_stem as tfs
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
    sources = ("surface_scan", "gather_gemm", "fused_stem", "gather_copy", "conv_epilogue",
               "conv_pool", "layer_norm", "lstm_gates")
    with ThreadPoolExecutor(max_workers=1) as pool:  # the host decoder beside them
        native_built = pool.submit(build_native)
        cuda_build.load_all(sources)  # one nvcc per source, started together
        native_lib, native_s = native_built.result()
    parts = []
    for src in sources:
        built = cuda_build.BUILD_SECONDS.get(src)
        ptxas = " | ".join(line.strip() for line in cuda_build.build_log(src).splitlines()
                           if "Used" in line or "spill" in line)
        parts.append(f"{src}.cu (nvcc "
                     f"{'%.2f s' % built if built is not None else 'skipped: already built'}"
                     f"; ptxas: {ptxas})")
    built = "skipped: already built" if native_s is None else f"{native_s:.2f} s"
    parts.append(f"native/evio.cc (g++ {built} into {native_lib.parent.relative_to(HERE)})")
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
        "ms": device_ms(k1_call(uniform), K1_KERNELS),
        "bin_ms": device_ms(k1_call(uniform), "bin_events_kernel"),
        "clustered_ms": device_ms(k1_call(clustered), K1_KERNELS),
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
    # K1 with a stream axis, beside the one-stream kernels (phase 23)
    k1s = k1_streams_phase(dev, smi)

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

    def pipeline():
        return StreamingPipeline(model.net, model.params, capacity=CAPACITY,
                                 t_chunks=T_CHUNKS, wire="plain", postprocess=post,
                                 max_in_flight=2, device=dev)

    # one stream on the card: the first dispatch runs eagerly, the second
    # captures the dispatch as a CUDA graph and every later one replays it
    pipe = pipeline()
    stream = synth_stream(np.random.RandomState(1), (DISPATCHES + 1) * T_CHUNKS, CAPACITY)
    items = np.split(stream, DISPATCHES + 1)[:DISPATCHES]
    # after them: up to five profiled replays, then phase 6's dispatch
    extra = synth_stream(np.random.RandomState(2), 6 * T_CHUNKS, CAPACITY)
    extra[:, 2] += stream[-1, 2]
    profiled = np.split(extra, 6)

    # the card's plan for a dispatch's T_CHUNKS frames, made (and its pairs
    # probed) before the counted runs; the main path: the counts are set to
    # 0 just before each run, read just after
    conv_stack.plan(model.net, dev, False, frames=T_CHUNKS)

    def counted(run):
        sc.reset_launches()
        ep.reset_launches()
        tfs.reset_launches()
        tcp.reset_launches()
        torch.cuda.synchronize()
        out = run()
        torch.cuda.synchronize()
        return out, (dict(sc.LAUNCHES), ep.LAUNCHES["conv_epilogue"],
                     tfs.LAUNCHES["fused_stem"], tcp.LAUNCHES["conv_pool"])

    def timed_run():
        # the first dispatch: cuDNN set-up; the second: the capture
        warm = list(pipe.serve(items[:2]))
        t0 = time.perf_counter()
        rest = list(pipe.serve(items[2:]))
        torch.cuda.synchronize()
        return warm, rest, time.perf_counter() - t0

    (warm, rest, wall), graph_counts = counted(timed_run)
    served = warm + rest
    # the same dispatches run eagerly, each launch counted by its wrapper
    with eager_dispatches():
        eager_pipe = pipeline()
        eager, eager_counts = counted(lambda: list(eager_pipe.serve(items)))
    main_launches, main_epilogues, main_stems, main_conv_pools = eager_counts

    require(len(served) == len(eager) == DISPATCHES,
            f"served {len(served)} and {len(eager)} of {DISPATCHES} dispatches")
    # T=200 chunks is one window: K1 once per dispatch, K2 never; K6, C1 and
    # the conv epilogue as EPILOGUES says
    require(main_launches == scan_launches(events=DISPATCHES, tsmap=0),
            f"main path launches {main_launches} for {DISPATCHES} single-window dispatches")
    require(main_epilogues == EPILOGUES * DISPATCHES and main_conv_pools == C1S * DISPATCHES,
            f"main path launched {main_epilogues} conv epilogues and C1 {main_conv_pools} "
            f"times for {DISPATCHES} dispatches")
    require(main_stems == STEMS * DISPATCHES,
            f"main path launched K6 {main_stems} times for {DISPATCHES} dispatches")
    # the graph path: one eager dispatch and one capture launch through the
    # wrappers, the replays launch none of their own
    stats = dict(pipe.stats)
    require(stats["eager_dispatches"] == stats["graph_captures"] == 1
            and stats["graph_replays"] == DISPATCHES - 1,
            f"the one-stream pipeline on the card dispatched {stats}")
    require(graph_counts == (scan_launches(events=2, tsmap=0), 2 * EPILOGUES, 2 * STEMS,
                             2 * C1S),
            f"the graph path's wrappers launched {graph_counts} for an eager dispatch and "
            "a capture")
    # every replayed dispatch bit for bit the eager one, and the end state
    for k, (a, b) in enumerate(zip(served, eager)):
        require(all(bit_equal(x, y) for x, y in zip(a.outputs, b.outputs)),
                f"replayed dispatch {k} differs from the eager one")
    require(bit_equal(pipe.state[0].surface, eager_pipe.state[0].surface)
            and torch.equal(pipe.state[0].prev_ts, eager_pipe.state[0].prev_ts),
            "the graph path's end state differs from the eager path's")
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
    replay_kernels = kernels_in_a_replay(
        pipe, profiled[:5], {"surface_scan_events": 1, "fused_stem": STEMS, "conv_pool": C1S,
                         "conv_epilogue": EPILOGUES})
    print(f"path: eFCN {H}x{W} conv1..conv7, {DISPATCHES} dispatches of {T_CHUNKS} x "
          f"{CAPACITY} events through StreamingPipeline(wire='plain', max_in_flight=2): "
          f"{n_events / wall:.0f} events/s over dispatches 3..{DISPATCHES} "
          f"({wall * 1e3 / (DISPATCHES - 2):.2f} ms/dispatch), dispatch latency "
          f"p50 {lat['dispatch_latency_ms']['p50']} ms over all {lat['n']}; "
          f"{stats['graph_replays']} dispatches replayed as a CUDA graph, each bit-equal to "
          f"the eager dispatch, a replay's kernels by name {replay_kernels}; eager "
          f"launches {main_launches} "
          f"({main_launches['surface_scan_events'] / DISPATCHES:g} K1 per dispatch), "
          f"conv epilogue {main_epilogues} ({main_epilogues / DISPATCHES:g} per dispatch), "
          f"K6 {main_stems} ({main_stems / DISPATCHES:g} per dispatch), "
          f"C1 {main_conv_pools} ({main_conv_pools / DISPATCHES:g} per dispatch); card {smi!r}",
          flush=True)

    # the ts-map engine's path: one full-width dispatch through K2, its
    # counts set to 0 just before it and read just after
    sc.reset_launches()
    ep.reset_launches()
    tfs.reset_launches()
    tcp.reset_launches()
    st_t, out_t = model.net.scan_parallel(model.params, st0, c0, integrate_engine="tsmap")
    torch.cuda.synchronize()
    tsmap_launches = dict(sc.LAUNCHES)
    require(tsmap_launches == scan_launches(events=0, tsmap=1),
            f"ts-map path launches {tsmap_launches} for one single-window dispatch")
    require(ep.LAUNCHES["conv_epilogue"] == EPILOGUES and tcp.LAUNCHES["conv_pool"] == C1S
            and tfs.LAUNCHES["fused_stem"] == STEMS,
            f"ts-map path launched {ep.LAUNCHES['conv_epilogue']} conv epilogues, K6 "
            f"{tfs.LAUNCHES['fused_stem']} times and C1 {tcp.LAUNCHES['conv_pool']} times")
    require(bit_equal(st_t[0].surface, st_e[0].surface)
            and float((out_t - out_e).abs().max()) <= OUT_TOL,
            "ts-map engine's dispatch differs from the default engine's")
    print(f"tsmap-path: one {T_CHUNKS}-chunk dispatch through EventNetwork.scan_parallel("
          f"integrate_engine='tsmap'): surface bit-equal and outputs within {OUT_TOL} of "
          f"the default engine's; launches {tsmap_launches}, conv epilogue "
          f"{ep.LAUNCHES['conv_epilogue']}, K6 {tfs.LAUNCHES['fused_stem']}, C1 "
          f"{tcp.LAUNCHES['conv_pool']}", flush=True)

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
        list(pipe.serve(profiled[5:]))
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
    # K6's launches are the main path's, as K1's are
    stem_kernel = {**stem_kernel_phase(dev, model, c0), "launches": main_stems}
    gather_copy = gather_copy_phase(dev)
    # phase 35 here: late in a long run the profiler's traces lose records
    epilogue = {**epilogue_phase(dev, smi), "launches": main_epilogues}  # the main path's
    conv_pool = {**conv_pool_phase(dev, smi), "launches": main_conv_pools}
    rvt_kernels = rvt_phase(dev, smi)
    stem_path_phase(model, c0, smi)
    tier_phase(dev, args, layer_defs, num_classes, num_bbox, c0, smi)
    kwargs = yolo_kwargs(args, layer_defs, num_classes, num_bbox, dev)
    checkpoint_phase(model, kwargs, items, smi)
    frame_phase(model, kwargs, items, smi)
    ts_window_phase(model, smi)
    maxplus_phase(model, c0, k1_info, smi)
    wire_phase(dev, smi)
    serving = multistream_phase(model, num_classes, num_bbox, smi)
    serve_cli_phase(dev, layer_defs, num_classes, smi)
    data_plane_phase(dev, native_lib, smi)
    trainer_phase(dev, args, smi)
    cli_phases(dev, args, num_classes, smi)
    mesh = mesh_phase(dev, args, model, num_classes, num_bbox, smi)
    ranks_phase(mesh, smi)
    orbax_phase(model, kwargs, items, smi)
    ranks_cli_phase(dev, smi)
    memory_model_phase(dev, smi)
    # the mesh paths' launches (phase 30): K1 on the engine's scan_parallel
    # and the mesh pipeline, K3 on the engine's 'sparse_pallas' scan
    rulebook_kernels[0]["mesh_launches"] = mesh["k3_launches"]

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
    kernels.append({
        "name": "surface_scan_events_streams", "route": "cuda",
        "source": "async_ev_cnn_torch/csrc/surface_scan.cu",
        "replaces": "async_ev_cnn_tpu/ops/pallas_scan.py:273",
        # K1 with a stream axis (the TPU kernel under vmap): the launches of
        # phase 24's S=8 run, this slice's main path
        "launches": serving[K1_STREAMS]["launches"]["surface_scan_events_streams"],
        "max_abs_err": k1s["max_abs_err"], "ms": k1s["ms"], "plain_ms": k1s["plain_ms"],
        "bound_ms": k1s["bound"][0], "bound_by": k1s["bound"][1], "library_ms": None,
        "streams": k1s["streams"], "singles_ms": k1s["singles_ms"],
        "call_ms": k1s["call_ms"], "singles_call_ms": k1s["singles_call_ms"],
        "mesh_launches": {
            "engine_scan_parallel": mesh["scan_launches"]["surface_scan_events_streams"],
            "mesh_pipeline": mesh["mesh"]["launches"]["surface_scan_events_streams"]}})
    print(json.dumps({"kernels": kernels + rulebook_kernels
                      + [stem_kernel, gather_copy, epilogue, conv_pool] + rvt_kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


def path_rates(dev, runs: int = 3) -> list:
    """Phase 4's path, events/s over dispatches 2..16 of ``runs`` fresh
    pipelines, through the public entry points a parent commit shares."""
    from async_ev_cnn_torch.models.yolo import YoloEventTorch
    from async_ev_cnn_torch.utils.config import config
    from async_ev_cnn_torch.utils.serving import StreamingPipeline

    args = config(["-c", str(HERE / "configs" / "efcn_event.yml")])
    layer_defs = args.yolo_cnn_layers
    num_classes = list(layer_defs.values())[-1][3] - args.yolo_num_bbox * 5
    model = YoloEventTorch(
        args.frame_h, args.frame_w, num_classes, layer_defs, args.yolo_cnn_padding,
        args.yolo_num_cells_h, args.yolo_num_cells_w, args.yolo_num_bbox, alpha=0.1,
        leak=args.leak, conv_mode="full", device=dev)
    model.set_weights(make_params(layer_defs, np.random.RandomState(0)))
    items = np.split(synth_stream(np.random.RandomState(1), DISPATCHES * T_CHUNKS, CAPACITY),
                     DISPATCHES)
    rates = []
    for _ in range(runs):
        pipe = StreamingPipeline(model.net, model.params, capacity=CAPACITY,
                                 t_chunks=T_CHUNKS, wire="plain", max_in_flight=2, device=dev)
        list(pipe.serve(items[:1]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rest = list(pipe.serve(items[1:]))
        torch.cuda.synchronize()
        rates.append(sum(r.n_events for r in rest) / (time.perf_counter() - t0))
    return rates


def window_times(dev) -> dict:
    """The eFCN's ``scan_parallel`` over phase 34's T=200 chunks with
    ``window_budget_mb`` at each of MEM_BUDGETS_MB (and unwindowed): the
    window ``auto_window`` picks, ms a call (CUDA events, median of 5
    means of 3 calls) and the peak above the bytes before the call."""
    from async_ev_cnn_torch.layers.network import EventNetwork
    from async_ev_cnn_torch.utils.config import config
    from async_ev_cnn_torch.utils.runner import pack_chunks
    from async_ev_cnn_torch.utils.weights import params_from_jax

    layer_defs = config(["-c", str(HERE / "configs" / "efcn_event.yml")]).yolo_cnn_layers
    rng = np.random.RandomState(34)
    net = EventNetwork(layer_defs, H, W, leak=1e-4, alpha=0.1, padding="SAME",
                       conv_mode="full")
    params = params_from_jax(make_params(layer_defs, rng), dev)
    state = net.init_state(params, dev)
    n = T_CHUNKS * CAPACITY
    cols = [rng.randint(0, H, n), rng.randint(0, W, n), np.sort(rng.randint(1, 5000, n))]
    chunks = pack_chunks(np.stack(cols, axis=-1).astype(np.int32), CAPACITY, device=dev)
    out = {}
    for budget in (None,) + MEM_BUDGETS_MB:
        def call(budget=budget):
            return net.scan_parallel(params, state, chunks, window_budget_mb=budget)
        ms = time_ms(call, 3)
        _, peak, _ = peak_bytes(call)
        out[str(budget)] = {"window": None if budget is None else net.auto_window(T_CHUNKS, budget),
                            "ms": ms, "peak_mb": peak / 2**20}
    return out


def kernel_times() -> dict:
    """K2 and K6 at the main path's shapes by device time, phase 4's path
    by events/s and the eFCN's windowed scan_parallel (:func:`window_times`),
    with the package that ``sys.path`` finds: the worker of
    :func:`compare`.  Only public calls, which a parent commit shares."""
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
            "k6_sass_per_px_ch": None if sass is None else sass[3],
            "path_events_s": path_rates(dev), "window": window_times(dev)}


def compare(parent: Path) -> int:
    """K2, K6, phase 4's path and the eFCN's windowed scan_parallel of the
    checkout at ``parent`` against this one's on one card, in the order
    parent, this, this, parent: each a process of its own that imports its
    tree's package and builds its kernels."""
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
        f"SASS a pooled pixel and channel {r['k6_sass_per_px_ch']}), phase 4's path "
        f"{', '.join(f'{x:.0f}' for x in r['path_events_s'])} events/s, the eFCN's "
        "scan_parallel (T=200) " + ", ".join(
            f"at {b} MB window {v['window']} {v['ms']:.3f} ms peak {v['peak_mb']:.2f} MB"
            for b, v in r["window"].items()) for r in rows))
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
