"""What every engine of ``engines/`` shares: the completion clock, the
record of a run, the sample of requests that ``correct`` compares, the
switch that starts a traced run's profiler, and the comparison's
arithmetic.

An engine is a file ``engines/<engine>.py``, named by its configuration's
``engine``, that defines ``Engine(cfg, mix, seed, device, traffic)`` with
``warm_up()``, ``run(seconds, tracer=None) -> Record`` and
``compare(control=False) -> (program, control)``.  It drives the program
through its normal entry and records a completion mark after each
request's outputs.  A completion's host time is its CUDA event's time after
one reference event (:class:`Clock`).  After the window the outputs of a
sample of the requests, drawn from the seed (and always the last), are held
against the plain reference (``reference/``), which works every surface out
again from the same events and weights.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench import tracing
from portbench.inputs import rng_for
from portbench.reference import efcn as ref

#: frames a block of the reference's dense network
REF_FRAMES = 256
#: share of the window a traced run measures before its profiler starts
TRACE_FROM = 0.5


class Clock:
    """Completion marks: CUDA events on the card, the host clock on the CPU
    (where every operation has ended when it returns)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.ref = None
        self.t_ref = 0.0

    def anchor(self) -> None:
        if self.cuda:
            self.ref = torch.cuda.Event(enable_timing=True)
            self.ref.record()
            self.ref.synchronize()
        self.t_ref = time.perf_counter()

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def seconds(self, mark) -> float:
        if not self.cuda:
            return mark
        mark.synchronize()
        return self.t_ref + self.ref.elapsed_time(mark) / 1e3


@dataclass
class Request:
    due: float
    events: int
    frames: int
    mark: object = None
    done: float | None = None


@dataclass
class Record:
    """What one run measured: the readers in ``metrics/`` take it."""

    seconds: float
    t_start: float
    requests: list = field(default_factory=list)
    host_gaps_s: list = field(default_factory=list)
    lateness_s: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    config: dict = field(default_factory=dict)
    mix: dict = field(default_factory=dict)
    setup_s: float = 0.0
    trace: object = None
    kept: list = field(default_factory=list)
    #: open loop: requests due in the window and never handed over
    backlog: int = 0
    #: a traced run: the requests handed over, and the time, before the
    #: profiler started (None: untraced)
    trace_from: int | None = None
    trace_t0: float | None = None

    def completed(self) -> list:
        """The requests whose outputs were complete inside the window."""
        end = self.t_start + self.seconds
        return [r for r in self.requests if r.done is not None and r.done <= end]


class Sample:
    """A uniform sample of ``size`` requests of the window, drawn from the
    seed as they arrive (reservoir sampling), and the last request."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = rng_for(seed, 2)
        self.slots: dict = {}
        self.last = None

    def offer(self, j: int) -> None:
        self.last = (j, {})
        if len(self.slots) < self.size:
            self.slots[j] = {}
            return
        r = int(self.rng.integers(0, j + 1))
        if r < self.size:
            del self.slots[sorted(self.slots)[r]]
            self.slots[j] = {}

    def put(self, j: int, key: str, value) -> None:
        if j in self.slots:
            self.slots[j][key] = value
        if self.last is not None and self.last[0] == j:
            self.last[1][key] = value

    def chosen(self) -> dict:
        out = dict(self.slots)
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return out


class TraceSwitch:
    """Starts the traced run's profiler partway through the window: the
    first part is measured as an untraced run is (the host-clock readers of
    a traced run read it), the rest under the profiler (the device readers
    read it).  ``poll`` runs at each handover."""

    def __init__(self, tracer, rec: Record):
        self.tracer, self.rec = tracer, rec
        self.at = rec.t_start + TRACE_FROM * rec.seconds
        self.on = False

    def source_range(self):
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(tracing.SOURCE_RANGE)

    def poll(self, now: float) -> None:
        if self.tracer is not None and not self.on and now >= self.at:
            self.rec.trace_from, self.rec.trace_t0 = len(self.rec.requests), now
            self.tracer.start()
            self.on = True

    def close(self) -> None:
        if self.on:
            self.tracer.stop()


def wait_until(t: float) -> None:
    """Wait for a due time by spinning on the clock: a sleeping host wakes
    up late by a varying amount, which would be the generator's own noise."""
    while time.perf_counter() < t:
        pass


def chunks(items, t: int, e: int, device):
    """Items of S streams -> ``[S, T, E]`` y, x, ts and valid on ``device``
    (an item shorter than ``t * e`` is padded with invalid slots)."""
    s = len(items)
    arr = np.zeros((s, t * e, 3), np.int64)
    valid = np.zeros((s, t * e), bool)
    for i, it in enumerate(items):
        arr[i, :len(it)] = it[:, :3]
        valid[i, :len(it)] = True
    a = torch.from_numpy(arr).to(device).view(s, t, e, 3)
    v = torch.from_numpy(valid).to(device).view(s, t, e)
    return a[..., 0], a[..., 1], a[..., 2], v


def grid(frames, weights, cfg, use_tf32=False):
    """The reference's grids of ``[N, 1, H, W]`` surfaces, in blocks."""
    out = [ref.dense_grid(frames[i:i + REF_FRAMES], weights, cfg["layers"], cfg["alpha"],
                          use_tf32) for i in range(0, frames.shape[0], REF_FRAMES)]
    return torch.cat(out)


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    scale = float(want.abs().max())
    return float((got.float() - want).abs().max()) / max(scale, 1e-30)


def free(device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()


def fold(acc: dict, outputs, surface, want_surface) -> None:
    """Raise ``acc``'s gaps to those of one request."""
    for got, want in outputs:
        acc["out_gap"] = max(acc["out_gap"], gap(got.reshape(want.shape), want))
    acc["surface_gap"] = max(acc["surface_gap"], gap(surface, want_surface))
