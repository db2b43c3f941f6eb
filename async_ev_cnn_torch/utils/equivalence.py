"""Async-vs-dense equivalence harness.

Counterpart of ``async_ev_cnn_tpu/utils/equivalence.py``: the stateful
async network and the dense oracle run in lockstep on the same synthetic
event stream, and every layer's featuremap is compared at every step.  The
JAX package fuses the run into one jitted ``lax.scan``; here it is a Python
loop whose per-step differences stay on the device until the end.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from async_ev_cnn_torch.layers.network import EventNetwork, dense_forward
from async_ev_cnn_torch.layers.types import EventChunk
from async_ev_cnn_torch.ops.integrate import integrate_step
from async_ev_cnn_torch.utils.device import resolve_device


class EquivalenceReport(NamedTuple):
    max_diff: "OrderedDict[str, float]"  # per layer, max over all steps
    worst_step: "OrderedDict[str, int]"


def make_stream(
    rng: np.random.RandomState,
    steps: int,
    events_per_step: int,
    h: int,
    w: int,
    max_dt: int = 10,
    clustered: bool = False,
    cluster_radius: int = 4,
    random_polarity: bool = False,
    device=None,
) -> EventChunk:
    """Synthetic stream of ``steps`` chunks of ``events_per_step`` random
    events with sorted, strictly advancing timestamps, as stacked ``[T, E]``
    tensors on ``device`` (``cuda`` when not given).  The numpy draws are the
    JAX package's, call for call, so one seed gives both the same stream.

    ``clustered=True`` draws events around a slowly drifting centre (the
    spatial statistics of real DVS streams) instead of uniformly.
    """
    dev = resolve_device(device)
    ts_steps = []
    prev = 0
    for _ in range(steps):
        ts = np.sort(rng.randint(1, max_dt, size=events_per_step)) + prev
        prev = int(ts[-1])
        ts_steps.append(ts)
    ts = np.stack(ts_steps).astype(np.int32)
    if clustered:
        cy = (h / 2 + h / 3 * np.sin(np.arange(steps) * 0.05))[:, None]
        cx = (w / 2 + w / 3 * np.cos(np.arange(steps) * 0.04))[:, None]
        y = np.clip(np.round(cy + rng.randn(steps, events_per_step) * cluster_radius),
                    0, h - 1)
        x = np.clip(np.round(cx + rng.randn(steps, events_per_step) * cluster_radius),
                    0, w - 1)
        y = y.astype(np.int32)
        x = x.astype(np.int32)
    else:
        y = rng.randint(0, h, size=(steps, events_per_step)).astype(np.int32)
        x = rng.randint(0, w, size=(steps, events_per_step)).astype(np.int32)
    p = (rng.randint(0, 2, size=(steps, events_per_step)).astype(np.int32)
         if random_polarity else np.zeros_like(y))
    valid = np.ones((steps, events_per_step), bool)
    return EventChunk(*(torch.from_numpy(a).to(dev) for a in (y, x, ts, p, valid)))


def run_equivalence(
    net: EventNetwork,
    params,
    chunks: EventChunk,
    dense_variant: str = "tf",
    device=None,
) -> EquivalenceReport:
    """Lockstep comparison on ``device`` (``cuda`` when not given); returns
    per-layer max |async - dense| over all steps.  ``params`` and ``chunks``
    are moved there.  The dense side integrates its own frame and runs the
    dense oracle on it each step."""
    dev = resolve_device(device)
    params = {k: v.to(dev) for k, v in params.items()}
    chunks = EventChunk(*(f.to(dev) for f in chunks))
    ispec = net.event_layers[0].spec
    layer_names = [ld.name for ld in net.event_layers]

    state = net.init_state(params, dev)
    frame = torch.zeros(ispec.out_shape, dtype=torch.float32, device=dev)
    prev_ts = torch.zeros((), dtype=torch.int32, device=dev)
    diffs = []
    for i in range(chunks.y.shape[0]):
        chunk = EventChunk(*(f[i] for f in chunks))
        state, ios = net.forward(params, state, chunk)
        if ispec.channels == 1:
            f2, prev_ts, _, _ = integrate_step(
                frame[0], prev_ts, chunk.y, chunk.x, chunk.ts, chunk.valid, ispec.leak)
            frame = f2[None]
        else:
            frame, prev_ts, _, _ = integrate_step(
                frame, prev_ts, chunk.y, chunk.x, chunk.ts, chunk.valid, ispec.leak,
                p=chunk.p)
        dense = dense_forward(net.event_layers, params, frame, dense_variant,
                              alpha=net.alpha)
        diffs.append(torch.stack(
            [(ios[n].featuremap - dense[n]).abs().max() for n in layer_names]))
    diffs = torch.stack(diffs).cpu().numpy()  # [steps, n_layers]
    report = EquivalenceReport(OrderedDict(), OrderedDict())
    for i, n in enumerate(layer_names):
        report.max_diff[n] = float(diffs[:, i].max())
        report.worst_step[n] = int(diffs[:, i].argmax())
    return report
