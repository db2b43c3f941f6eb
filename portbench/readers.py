"""What the metric files of ``metrics/`` share: each reads one number from
a run's :class:`~portbench.harness.Record`, or ``None`` where the run has
nothing to read (the harness then leaves the metric out of the line)."""

from __future__ import annotations

import statistics

from portbench import work

# the layer entries the traced run wraps, where their callers look them up
INTEGRATE = ("async_ev_cnn_torch.layers.network", "integrate_parallel", "integrate")
CONV_STACK = ("async_ev_cnn_torch.layers.network", "EventNetwork.full_frame_forward",
              "conv_stack")


def _mask(mask, *args, **kwargs):
    return mask


def _kernel_shape(fm, ca, kernel_hwio, *args, **kwargs):
    return tuple(kernel_hwio.shape)


# 'sparse_pallas' at stride 1: the active sites a layer's rulebook is built
# from, then K3 over the blocks that hold them (when they fit)
K3_SITES = ("async_ev_cnn_torch.layers.conv2d", "mask_to_block_coords", "k3.sites", _mask)
K3 = ("async_ev_cnn_torch.ops.rulebook_gemm", "rulebook_gather_gemm_blocks", "k3",
      _kernel_shape)


def p95(values) -> float | None:
    if len(values) < 20:
        return None
    return statistics.quantiles(values, n=20)[18]


def events_per_s(rec):
    """The valid events of every request whose outputs were complete on the
    card inside the window, over the window's seconds."""
    done = rec.completed()
    return sum(r.events for r in done) / rec.seconds if done else None


def events_per_s_untraced(rec):
    """As :func:`events_per_s`, over the part of the window before a traced
    run's profiler started (the whole window of an untraced run)."""
    _, _, seconds, t_end = untraced(rec)
    done = [r for r in rec.requests if r.done is not None and r.done <= t_end]
    return sum(r.events for r in done) / seconds if done and seconds > 0 else None


def flag_reads_per_chunk(rec):
    """Host reads of device flags a chunk, summed over the conv layers
    (``EventNetwork.layer_counts[...]["host_syncs"]``)."""
    chunks = rec.counters.get("chunks")
    return rec.counters.get("host_syncs", 0) / chunks if chunks else None


def dense_fallback_share(rec):
    """Share of the conv layers' steps that fell back to the dense update
    (``layer_counts[...]["dense_fallbacks"]`` over the layer calls)."""
    calls = rec.counters.get("conv_calls")
    return 100.0 * rec.counters.get("dense_fallbacks", 0) / calls if calls else None


def untraced(rec):
    """``(gaps, lateness, seconds, t_end)`` of the part of the window before
    a traced run's profiler started (the whole window of an untraced run):
    the host-clock readers of a traced run read only that part."""
    if rec.trace_from is None:
        return (rec.host_gaps_s, rec.lateness_s, rec.seconds, rec.t_start + rec.seconds)
    n = rec.trace_from
    return (rec.host_gaps_s[:max(n - 1, 0)], rec.lateness_s[:n],
            rec.trace_t0 - rec.t_start, rec.trace_t0)


def traced_schedule(rec):
    """An open loop's traced part: ``(lateness p95 s, backlog, interval s)``,
    how late its generator handed items over while the profiler ran, the
    requests due and never handed over, and the time between two items'
    due times; None for a closed loop or an untraced run."""
    if rec.trace_from is None or rec.mix.get("loop") != "open":
        return None
    late = rec.lateness_s[rec.trace_from:]
    worst = p95(late) if len(late) >= 20 else max(late, default=0.0)
    mix = rec.mix
    interval = int(mix["chunks"]) * int(mix["events_per_chunk"]) / float(
        mix["rate_events_per_s"])
    return worst, rec.backlog, interval


def on_schedule(rec) -> bool:
    """Whether the load held while the profiler ran: a closed loop always
    does; an open loop's generator has to leave no backlog and hand items
    over, at the 95th percentile, less than an item's interval late.  A
    traced part that fell behind ran at another load than the cell's, and
    its device readings are not the cell's."""
    sched = traced_schedule(rec)
    return sched is None or (sched[1] == 0 and sched[0] < sched[2])


def host_ms_per_dispatch(rec):
    gaps = untraced(rec)[0]
    return statistics.median(gaps) * 1e3 if gaps else None


def _traced(rec) -> bool:
    """Whether the run has a device trace with device work in it."""
    return rec.trace is not None and bool(rec.trace.device)


def range_ms_per_call(rec, name: str):
    if not _traced(rec):
        return None
    calls, ns = rec.trace.range_device_ns(name)
    return ns / 1e6 / calls if calls else None


def idle_share(rec):
    if not _traced(rec) or rec.trace.window() is None:
        return None
    lo, hi = rec.trace.window()
    return 100.0 * (1.0 - rec.trace.busy_ns() / (hi - lo))


def mfu(rec):
    """The dense network's operations on every frame completed in the
    (untraced part of the) window, as a share of the card's float32 peak
    over it."""
    cfg = rec.config
    _, _, seconds, t_end = untraced(rec)
    frames = sum(r.frames for r in rec.requests if r.done is not None and r.done <= t_end)
    if not frames:
        return None
    flops = work.frame_flops(cfg["layers"], cfg["frame_h"], cfg["frame_w"]) * frames
    return 100.0 * flops / seconds / work.PEAK_F32_FLOPS


def k3_ms_per_chunk(rec):
    """K3's device time over the chunks handed over while the profiler ran."""
    chunks = len(rec.requests) - (rec.trace_from or 0)
    if not _traced(rec) or chunks <= 0:
        return None
    calls, ns = rec.trace.range_device_ns(K3[2])
    return ns / 1e6 / chunks if calls else None


def k3_roofline(rec):
    """The least time of the rulebook work that K3's calls were given (the
    active sites of each call, :func:`portbench.work.rulebook_work`) over
    K3's device time."""
    if not _traced(rec):
        return None
    calls, ns = rec.trace.range_device_ns(K3[2])
    if not calls or ns <= 0:
        return None
    least, sites = 0.0, None
    for name, value in rec.kept:
        if name == K3_SITES[2]:
            sites = value
        elif name == K3[2] and sites is not None:
            kh, kw, cin, cout = value
            least += work.least_seconds(*work.rulebook_work(sites, kh, kw, cin, cout))
            sites = None
    return 100.0 * least / (ns / 1e9)
