"""Background batch prefetching: host-side workers + device double-buffering.

Counterpart of ``async_ev_cnn_tpu/data/prefetch.py``: :class:`Prefetcher` is
copied (its process mode starts its workers by ``spawn``, which a process
holding a CUDA context needs, and reports a missing ``dill`` plainly);
:func:`device_prefetch` is written for the card.

The reference keeps a pool of daemon ``multiprocessing.Process`` workers
feeding a queue, with the preprocessing closure shipped via dill
(the reference's src/readers/event_reader.py:230-276) and blocks until the
queue is full on first use (event_reader.py:258-260).  Here:

* :class:`Prefetcher` — persistent background *threads* by default (numpy
  decode releases the GIL; threads avoid re-opening the dataset per worker)
  or *processes* (``mode='process'``, dill-pickled preprocessing fn) for
  CPU-bound preprocessing.
* :func:`device_prefetch` — wraps any host batch iterator with
  double-buffering into pinned host memory, the copies to the card on a
  side CUDA stream, so the transfer of batch t+1 overlaps compute of
  batch t.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from async_ev_cnn_torch.utils.device import resolve_device

_ERR = "__prefetch_error__"  # queue sentinel: ('__prefetch_error__', repr)


def _mp_worker(q, blob, worker_id, num, batch_size, split):
    """Module-level process-mode worker: everything (dataset + fn) ships
    in the dill blob, so the worker survives spawn-based start methods —
    a nested closure target crashed mp.Process.start() on platforms
    where fork isn't the default."""
    import dill

    save, fn = dill.loads(blob)
    # shard the file space by worker to avoid duplicate reads
    for s in ("train", "validation", "test"):
        save._files[s] = save._files[s][worker_id::num] or save._files[s]
        save._labels[s] = save._labels[s][worker_id::num] or save._labels[s]
        save._epoch_order[s] = np.arange(len(save._files[s]))
        save._cursors[s] = 0
    try:
        while True:
            q.put(save.next_batch(batch_size, dataset=split,
                                  preprocessing_fn=fn, threads=1))
    except BaseException as e:  # noqa: BLE001 — surfaced in the consumer
        q.put((_ERR, repr(e)))


class Prefetcher:
    """Keeps up to ``queue_size`` ready batches ahead of the consumer.

    A worker failure (empty split, too-many-unreadable-examples, a bug in
    the preprocessing fn) is re-raised from :meth:`get` — silent worker
    death used to leave the consumer blocked forever.
    """

    def __init__(self, dataset, batch_size, split, preprocessing_fn,
                 num_workers=2, queue_size=4, mode="thread"):
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._workers = []
        if mode == "thread":
            # one puller thread per worker; cursor advancement is
            # serialized by the dataset's Lock (_next_files).
            def work():
                try:
                    while not self._stop.is_set():
                        batch = dataset.next_batch(
                            batch_size, dataset=split,
                            preprocessing_fn=preprocessing_fn, threads=1,
                        )
                        while not self._stop.is_set():
                            try:
                                self._queue.put(batch, timeout=0.1)
                                break
                            except queue.Full:
                                continue
                except BaseException as e:  # noqa: BLE001
                    self._put_error(e)

            for _ in range(num_workers):
                t = threading.Thread(target=work, daemon=True)
                t.start()
                self._workers.append(t)
        elif mode == "process":
            import multiprocessing

            try:
                import dill
            except ImportError as e:
                raise RuntimeError(
                    "Prefetcher(mode='process') ships the dataset and the "
                    "preprocessing fn to its workers with dill, which is not "
                    "installed; use mode='thread'") from e
            # spawn, not fork: a forked child of a process that holds a CUDA
            # context (or any thread) inherits them in an unusable state
            mp = multiprocessing.get_context("spawn")
            blob = dill.dumps((dataset, preprocessing_fn))
            self._mp_queue = mp.Queue(maxsize=queue_size)

            for i in range(num_workers):
                p = mp.Process(
                    target=_mp_worker,
                    args=(self._mp_queue, blob, i, num_workers, batch_size,
                          split),
                    daemon=True,
                )
                p.start()
                self._workers.append(p)

            def pump():
                while not self._stop.is_set():
                    try:
                        item = self._mp_queue.get(timeout=0.1)
                    except queue.Empty:
                        continue
                    while not self._stop.is_set():
                        try:  # bounded put: stop() must not strand the
                            self._queue.put(item, timeout=0.1)  # pump
                            break
                        except queue.Full:
                            continue

            t = threading.Thread(target=pump, daemon=True)
            t.start()
        else:
            raise ValueError(f"unknown prefetch mode {mode!r}")

    def _put_error(self, exc):
        while not self._stop.is_set():
            try:
                self._queue.put((_ERR, repr(exc)), timeout=0.1)
                return
            except queue.Full:
                continue

    def get(self, timeout=None):
        item = self._queue.get(timeout=timeout)
        # == not `is`: the process-mode sentinel crosses pickling and
        # comes back as a different str object
        if isinstance(item, tuple) and len(item) == 2 and item[0] == _ERR:
            raise RuntimeError(f"prefetch worker failed: {item[1]}")
        return item

    def __iter__(self):
        while True:
            yield self.get()

    def stop(self):
        self._stop.set()
        for w in self._workers:
            if hasattr(w, "terminate"):
                w.terminate()


def _map(fn, batch):
    """``fn`` over every array or tensor of a batch (nested lists, tuples
    and dicts; other leaves pass through)."""
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        return fn(batch)
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        out = [_map(fn, v) for v in batch]
        return type(batch)(*out) if hasattr(batch, "_fields") else type(batch)(out)
    return batch


def _leaves(batch) -> list:
    out = []
    _map(out.append, batch)
    return out


def _pinned(a) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
    return t.pin_memory()


def device_prefetch(iterator: Iterator, size: int = 2, device=None) -> Iterator:
    """Double-buffer host batches onto ``device`` (``cuda`` when not given;
    raises where there is none), keeping ``size`` batches in flight.

    On the card each batch's arrays are copied into pinned host memory and
    from there to the card on a side CUDA stream, without blocking the
    host, while the consumer computes on the batch before; an event
    recorded after a batch's copies is waited on by the consumer's current
    stream before the batch is handed out, so the consumer's work
    enqueued afterwards reads it complete, and each tensor is marked as
    used on that stream for the caching allocator.  Batches are nested
    lists, tuples or dicts of numpy arrays or tensors, delivered in order.
    On the CPU the batches are copied as they come."""
    dev = resolve_device(device)
    it = iter(iterator)
    if dev.type != "cuda":
        for batch in it:
            yield _map(lambda a: torch.as_tensor(a).to(dev), batch)
        return
    side = torch.cuda.Stream(dev)
    buf: collections.deque = collections.deque()

    def put():
        try:
            batch = next(it)
        except StopIteration:
            return
        host = _map(_pinned, batch)
        with torch.cuda.stream(side):
            out = _map(lambda t: t.to(dev, non_blocking=True), host)
            done = torch.cuda.Event()
            done.record(side)
        buf.append((out, done))

    for _ in range(size):
        put()
    while buf:
        out, done = buf.popleft()
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        for t in _leaves(out):
            t.record_stream(consumer)
        put()
        yield out
