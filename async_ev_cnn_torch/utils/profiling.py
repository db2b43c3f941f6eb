"""Profiling and timing instrumentation.

Counterpart of ``async_ev_cnn_tpu/utils/profiling.py``:

* :class:`StepTimer` — running per-step stats with events/s, copied;
* :func:`profile_layers` and :func:`profile_layers_parallel` — per-layer
  time attribution by prefix ablation (the network truncated after layer
  k, for every k, and consecutive prefixes differenced), of the sequential
  and of the parallel-in-time engine;
* :func:`trace` — a context manager around ``torch.profiler`` that writes a
  Chrome trace (``chrome://tracing``, Perfetto).

On the card every probe is timed by CUDA events recorded around its run
after a ``torch.cuda.synchronize()``, so the time is the card's from the
first launch to the last; on the CPU by the host clock.  PyTorch runs
eagerly, so the JAX package's guards against a compiler hoisting or
dropping a probe's work are not needed here.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from async_ev_cnn_torch.layers.types import EventChunk


class StepTimer:
    """Accumulates per-step wall times and event counts."""

    def __init__(self):
        self.times: list[float] = []
        self.events: list[int] = []
        self._t0 = None

    def start(self):
        self._t0 = time.time()

    def stop(self, num_events: int = 0) -> float:
        dt = time.time() - self._t0
        self.times.append(dt)
        self.events.append(num_events)
        return dt

    @property
    def steps(self) -> int:
        return len(self.times)

    def summary(self, skip_warmup: int = 1) -> dict:
        t = np.asarray(self.times[skip_warmup:] or self.times)
        e = np.asarray(self.events[skip_warmup:] or self.events)
        return {
            "steps": self.steps,
            "mean_sec_per_step": float(t.mean()) if t.size else 0.0,
            "p50_sec_per_step": float(np.percentile(t, 50)) if t.size else 0.0,
            "p99_sec_per_step": float(np.percentile(t, 99)) if t.size else 0.0,
            "events_per_sec": float(e.sum() / t.sum()) if t.size and t.sum() else 0.0,
        }


def _elapsed_ms(fn, device) -> float:
    """Milliseconds ``fn()`` takes: on the card by CUDA events around it
    after a synchronize (the card's time from its first launch to its
    last), on the CPU by the host clock."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _best_ms(fn, device, reps: int) -> float:
    fn()  # warm-up: cuDNN's algorithm choice, the kernels' first build
    return min(_elapsed_ms(fn, device) for _ in range(reps))


def profile_layers(net, params, chunks, reps: int = 3, dispatches: int = 4):
    """Per-layer time attribution of the sequential engine by prefix
    ablation: ``dispatches`` passes of :meth:`EventNetwork.forward` over
    the ``[T, E]`` chunks, truncated after layer k, for every k.

    Returns a list of ``(layer_name, ms_per_chunk)`` rows (the first row is
    the integration layer; each later row that layer's marginal cost), plus
    a ``('TOTAL', ...)`` row."""
    device = chunks.y.device
    state0 = net.init_state(params, device)
    t_chunks = int(chunks.y.shape[0])
    steps = [EventChunk(*(f[k] for f in chunks)) for k in range(t_chunks)]

    def timed(upto):
        def run():
            for _ in range(dispatches):
                st = state0
                for chunk in steps:
                    st, _ = net.forward(params, st, chunk, upto=upto)

        return _best_ms(run, device, reps) / dispatches / t_chunks

    rows = []
    prev = 0.0
    for i, ld in enumerate(net.event_layers):
        total = timed(i)
        rows.append((ld.name, total - prev))
        prev = total
    rows.append(("TOTAL", prev))
    return rows


def profile_layers_parallel(net, params, chunks, reps: int = 3, dispatches: int = 8):
    """Stage attribution of the parallel-in-time path (``scan_parallel``):
    each probe runs the real ``integrate_parallel`` and the T-batched
    network truncated after k layers, ``dispatches`` times chained through
    the surface.  Row 0 ('integrate') is the surface reconstruction; a
    conv+pool pair the forward fuses is one row, as it runs as one op.

    Returns ``[(name, ms_per_dispatch_marginal), ..., ('TOTAL', ms)]``."""
    from async_ev_cnn_torch.ops.integrate import integrate_parallel

    if not net.is_all_full:
        raise ValueError("profile_layers_parallel requires an all-'full' net")
    device = chunks.y.device
    state0 = net.init_state(params, device)
    leak = net.event_layers[0].spec.leak

    def timed(upto):
        def run():
            surf, pts = state0[0].surface, state0[0].prev_ts
            for _ in range(dispatches):
                surfaces, last_ts = integrate_parallel(surf, pts, chunks, leak)
                if upto != 0:
                    net.full_frame_forward(params, state0, surfaces, upto=upto)
                surf, pts = surfaces[-1], last_ts[-1]

        return _best_ms(run, device, reps) / dispatches

    names = ["integrate"] + [ld.name for ld in net.event_layers[1:]]
    # conv+pool pairs the forward runs as ONE space-to-depth op must be
    # probed as one row: cutting between them would time an unfused conv
    # that the path never runs
    fused = net._s2d_pairs if net._fusion_active() else frozenset()
    probes = []
    k = 0
    while k < len(names):
        if (k - 1) in fused and k + 1 < len(names):
            probes.append((k + 1, f"{names[k]}+{names[k + 1]} (s2d)"))
            k += 2
        else:
            probes.append((k, names[k]))
            k += 1
    if net.dense_tail:
        probes.append((None, "tail"))  # upto=None: the full forward with its tail
    rows = []
    prev = 0.0
    for upto, name in probes:
        total = timed(upto)
        rows.append((name, total - prev))
        prev = total
    rows.append(("TOTAL", prev))
    return rows


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the block with ``torch.profiler`` (the CPU, and the card where
    there is one) and write its Chrome trace to ``log_dir/trace.json``; a
    no-op when ``log_dir`` is None.  Yields the profiler (or None)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
