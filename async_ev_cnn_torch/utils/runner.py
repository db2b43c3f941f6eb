"""Streaming inference runners and event-stream packing.

Counterpart of ``async_ev_cnn_tpu/utils/runner.py`` (its docstring has the
design): iterate the test set, split each example's event stream into
micro-batches by count (``batch_event_size``) or by time window
(``batch_event_usec``), maintain the integrated frame alongside, feed the
network, record wall-clock timings and events/s.  The runners take a
``device`` (``cuda`` when not given; raises where there is none) for what
they build themselves: the integrated frame and the packed chunks.  A
timed step ends in a copy of its result to the host, which waits for the
card.  :class:`MultiStreamRunner` (the mesh-sharded serving runner) waits
for the multi-device slice; one-host multi-stream serving is
:class:`~async_ev_cnn_torch.utils.serving.StreamingPipeline`.
"""

from __future__ import annotations

import time
from functools import partial

import numpy as np
import torch

from async_ev_cnn_torch.layers.types import EventChunk, validate_int32_ts
from async_ev_cnn_torch.ops.integrate import integrate_frame_chunked
from async_ev_cnn_torch.utils import viz
from async_ev_cnn_torch.utils.device import resolve_device
from async_ev_cnn_torch.utils.transforms import data_transform


def _to_host(x) -> np.ndarray:
    """A result as a host array: a tensor is copied (which waits for the
    card), anything else taken as it is."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def split_micro_batches(events: np.ndarray, batch_event_size=None, batch_event_usec=None):
    """Split an ``[N, 3]`` (y, x, ts) stream into micro-batches.

    By time window when ``batch_event_usec`` is given (runner.py:66-69),
    else by count (runner.py:71-72).
    """
    if events.shape[0] == 0:
        return []  # a fully-cropped-out example is zero micro-batches
    if batch_event_usec is not None:
        # column 2 is ts by the [y, x, ts(, p)] layout — `[:, -1]` read
        # the POLARITY column under keep_polarity, collapsing the whole
        # stream into one bin
        ts = events[:, 2]
        bins = np.arange(0, ts[-1], batch_event_usec)
        bin_ids = np.digitize(ts, bins)
        split_at = np.where(bin_ids[:-1] != bin_ids[1:])[0] + 1
        return np.array_split(events, split_at, axis=0)
    num = int(np.ceil(events.shape[0] / batch_event_size))
    return np.array_split(events, num, axis=0)


class Runner:
    """Base runner: reads batches, micro-batches events, times the network."""

    profile_integration = True  # include frame integration in the timed span
    needs_frame = True  # the event runner ignores the frame; skip its cost

    def __init__(self, args, reader, device=None):
        self.args = args
        self.reader = reader
        self.device = resolve_device(device)
        self.num_classes = reader.num_classes()
        label_to_idx = reader.label_to_idx()
        labels = np.array(list(label_to_idx.keys()))
        order = np.argsort(np.array(list(label_to_idx.values())))
        self.idx_to_label = labels[order]

    def feed_network(self, network, events_batch, frame, reset_state):
        raise NotImplementedError

    def show_frames(self, net_out, frame):  # pragma: no cover - GUI path
        drawn = viz.draw_bboxes(
            net_out, frame, self.args.yolo_num_cells_h, self.args.yolo_num_cells_w,
            self.num_classes, idx_to_label=self.idx_to_label, conf_threshold=0.1,
            nms_threshold=0.0, use_nms=True, max_thickness=1, highlight_top_n=2,
            resize_ratio=5,
        )
        for f in drawn:
            viz.show_frame(f, self.args.frame_delay)

    def run(self, network, max_examples=None, verbose=True):
        """Inference over the test set; returns aggregate timing stats."""
        args = self.args
        step_times = []
        total_events = 0
        n = 0
        num_batches = int(np.ceil(self.reader.test_size() / args.batch_size))
        if max_examples is not None:
            num_batches = min(num_batches, max_examples)
        want_frame = self.needs_frame or getattr(args, "show_frames", False)

        for i in range(num_batches):
            t_read = time.time()
            batch = self.reader.next_batch(
                args.batch_size, dataset="test",
                preprocessing_fn=partial(data_transform, args=args),
                concat_features=False, threads=args.reader_threads,
            )
            read_time = time.time() - t_read
            if args.batch_size == 1:
                examples = [batch[1]]
            else:
                # [B, max_len, 3] ragged-padded stack: slice each example
                # by its length (a padding row would integrate as a real
                # event at pixel (0, 0) with ts 0)
                lengths, ev_pad = batch[0], batch[1]
                examples = [ev_pad[b, : int(lengths[b])]
                            for b in range(ev_pad.shape[0])]

            for events in examples:  # each example streams independently
                frame_state = None
                reset_state = True
                for events_batch in split_micro_batches(
                    events, args.batch_event_size, args.batch_event_usec
                ):
                    if self.profile_integration:
                        t0 = time.time()
                    frame = None
                    if want_frame:
                        frame, prev_ts = integrate_frame_chunked(
                            events_batch, args.leak, args.frame_h,
                            args.frame_w, frame_state,
                            slice_len=max(256, args.batch_event_size),
                            device=self.device,
                        )
                        frame_state = [frame, prev_ts]
                    if not self.profile_integration:
                        t0 = time.time()

                    net_out = _to_host(self.feed_network(
                        network, events_batch, frame, reset_state))  # = sync point
                    dt = time.time() - t0
                    step_times.append(dt)
                    total_events += len(events_batch)
                    n += 1
                    if verbose:
                        print(
                            f"Test batch {i + 1:<2} - sec/step: {dt:.4f}  "
                            f"ev/s: {len(events_batch) / max(dt, 1e-9):,.0f}"
                            f"  reading: {read_time:.3f} sec")
                    if n % 1000 == 0 and verbose:
                        print(f"Mean fw time ({n} runs): "
                              f"{np.mean(step_times):.5f}")
                    if getattr(args, "show_frames", False):  # pragma: no cover
                        self.show_frames(net_out, _to_host(frame))
                    reset_state = False

        times = np.array(step_times[1:] or step_times)  # drop the warm-up step
        return {
            "steps": n,
            "mean_sec_per_step": float(times.mean()),
            "events_per_sec": float(total_events / max(np.array(step_times).sum(), 1e-9)),
            "events_per_sec_steady": float(
                (total_events / max(n, 1)) * len(times) / max(times.sum(), 1e-9)
            ),
        }


class EventRunner(Runner):
    """Drives :class:`YoloEventTorch` through its closure API
    (``build_graph``)."""

    profile_integration = False  # the event net does its own integration
    needs_frame = False  # feed_network ignores it — don't pay for it

    def feed_network(self, network, events_batch, frame, reset_state):
        return network(events_batch, reset_state)


class FrameRunner(Runner):
    """Drives a dense frame network on the accumulated frame per micro-batch
    (the frame models take the frame tensor; the numpy oracle reads a CPU
    one as an array)."""

    def feed_network(self, network, events_batch, frame, reset_state):
        return network(frame)


class ScanEventRunner(Runner):
    """Throughput mode: pre-chunks the whole example into padded ``[T, E]``
    chunks and runs one ``model.scan`` — one call per example instead of
    per micro-batch."""

    profile_integration = False

    def _pack(self, events):
        """Chunk by count, or by µs bins (padded variable occupancy) when
        ``batch_event_usec`` is set — mirrors split_micro_batches."""
        args = self.args
        if getattr(args, "batch_event_usec", None):
            return pack_chunks_usec(events, args.batch_event_size, args.batch_event_usec,
                                    device=self.device)
        return pack_chunks(events, args.batch_event_size, device=self.device)

    def run(self, model, max_examples=None, verbose=True):
        args = self.args
        times, total_events, examples = [], 0, 0
        num_batches = int(np.ceil(self.reader.test_size() / args.batch_size))
        if max_examples is not None:
            num_batches = min(num_batches, max_examples)
        state0 = model.init_state()
        for i in range(num_batches):
            _, events = self.reader.next_batch(
                args.batch_size, dataset="test",
                preprocessing_fn=partial(data_transform, args=args),
                concat_features=False, threads=args.reader_threads,
            )
            chunks = self._pack(events)
            t0 = time.time()
            _, outs = model.scan(state0, chunks)
            _to_host(outs[-1])  # host copy = true sync point
            dt = time.time() - t0
            times.append(dt)
            total_events += events.shape[0]
            examples += 1
            if verbose:
                print(f"Example {i + 1}: {events.shape[0]} events in {dt:.4f}s "
                      f"({events.shape[0] / max(dt, 1e-9):,.0f} ev/s)")
        steady = np.array(times[1:] or times)
        return {
            "examples": examples,
            "events_per_sec": float(total_events / max(sum(times), 1e-9)),
            "events_per_sec_steady": float(
                (total_events / max(examples, 1)) * len(steady) / max(steady.sum(), 1e-9)
            ),
        }


class MultiStreamRunner(Runner):
    """The JAX package's mesh-sharded serving runner (``--num_streams`` in
    ``run_networks``).  It needs the multi-device engine, which the port
    does not have yet."""

    def run(self, model, max_examples=None, verbose=True):
        raise NotImplementedError(
            "MultiStreamRunner shards streams over a device mesh and waits for "
            "the port's multi-device slice (ROADMAP queue 1 item 6); serve "
            "several streams on one card with utils.serving.StreamingPipeline")


def pad_chunks_t(chunks: EventChunk, t: int) -> EventChunk:
    """Pad stacked chunks ``[T0, E]`` to ``[t, E]`` with all-invalid (no-op)
    chunks."""
    t0 = chunks.y.shape[0]
    if t0 == t:
        return chunks
    return EventChunk(*(torch.cat([a, a.new_zeros((t - t0, *a.shape[1:]))]) for a in chunks))


def pack_chunks_usec(events: np.ndarray, capacity: int, batch_event_usec: int,
                     device=None) -> EventChunk:
    """Pack an ``[N, >=3]`` stream into stacked padded chunks ``[T,
    capacity]`` on ``device``, binned by time window (the reference's
    ``batch_event_usec`` micro-batching) instead of by count.

    Bins have variable occupancy; each is padded to the static ``capacity``
    with invalid (no-op) events.  A bin holding more than ``capacity``
    events is split by count, so no event is ever dropped.
    """
    dev = resolve_device(device)
    if events.shape[0] == 0:  # one all-invalid (no-op) chunk
        z = torch.zeros((1, capacity), dtype=torch.int32, device=dev)
        return EventChunk(y=z, x=z.clone(), ts=z.clone(), p=z.clone(),
                          valid=torch.zeros((1, capacity), dtype=torch.bool, device=dev))
    pieces = []
    for piece in split_micro_batches(events, batch_event_usec=batch_event_usec):
        if piece.shape[0] <= capacity:
            pieces.append(piece)
        else:
            num = int(np.ceil(piece.shape[0] / capacity))
            pieces.extend(np.array_split(piece, num, axis=0))
    validate_int32_ts(events[:, 2])
    t = len(pieces)
    has_p = events.shape[1] > 3
    planes = np.zeros((4, t, capacity), events.dtype)  # y, x, ts, p
    valid = np.zeros((t, capacity), bool)
    for i, piece in enumerate(pieces):
        k = piece.shape[0]
        planes[:3, i, :k] = piece[:, :3].T
        if has_p:
            planes[3, i, :k] = piece[:, 3]
        valid[i, :k] = True
    y, x, ts, p = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in planes)
    return EventChunk(y=y, x=x, ts=ts, p=p, valid=torch.from_numpy(valid).to(dev))


def pack_chunks(events: np.ndarray, capacity: int, device=None) -> EventChunk:
    """Pack an ``[N, >=3]`` (y, x, ts[, p]) stream into stacked padded
    chunks ``[T, capacity]`` on ``device``.  Polarity is carried when the
    4th column is present; timestamps go through the int32 contract
    checks."""
    dev = resolve_device(device)
    n = events.shape[0]
    validate_int32_ts(events[:, 2] if n else np.zeros(0, np.int32))
    t = max(1, int(np.ceil(n / capacity)))
    pad = t * capacity - n

    def column(i):
        col = np.concatenate([events[:, i], np.zeros(pad, events.dtype)])
        return torch.from_numpy(col.astype(np.int32).reshape(t, capacity)).to(dev)

    p = column(3) if events.shape[1] > 3 else torch.zeros(
        (t, capacity), dtype=torch.int32, device=dev)
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    return EventChunk(
        y=column(0), x=column(1), ts=column(2), p=p,
        valid=torch.from_numpy(valid.reshape(t, capacity)).to(dev),
    )
