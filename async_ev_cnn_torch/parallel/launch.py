"""Start ``n`` ranks on one host and collect what each returns.

    from async_ev_cnn_torch.parallel.launch import launch
    results = launch(fn, 4, args=(x,), backend="gloo")   # fn(*args) on 4 ranks

Each rank is a process started by ``torch.multiprocessing`` (spawn: a
fresh interpreter that imports ``fn`` by its module path, so ``fn`` must
live in a module that imports neither ``jax`` nor the JAX package).  The
ranks meet at a ``FileStore`` under a temporary directory, so groups of
ranks never share a rendezvous; each rank runs on one thread.  NCCL
ranks take a card each: more ranks than cards are refused before any
rank starts (NCCL refuses two ranks on one card; gloo ranks may share
one), and rank ``r`` computes on card ``r``, set before its group starts.
The parent waits at most ``timeout`` seconds, or with
``timeout=None`` until the ranks end, however long they run: a rank that
fails or outlives the deadline ends every rank and raises here.  Without a
deadline a rank left waiting in a collective still fails at the group
timeout (``mesh.TIMEOUT``).
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from async_ev_cnn_torch.parallel import mesh


def _rank_main(rank, fn, args, n, backend, store, out_dir):
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, store=dist.FileStore(store, n), rank=rank,
                            world_size=n, timeout=mesh.TIMEOUT)
    try:
        result = fn(*args)
        # every rank is done with every collective before any leaves
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (Path(out_dir) / f"rank{rank}.pkl").write_bytes(pickle.dumps(result))


def launch(fn, n: int, args: tuple = (), backend: str = "gloo",
           timeout: float | None = 300.0) -> list:
    """Run ``fn(*args)`` on ``n`` ranks of a ``backend`` world; returns the
    ranks' results in rank order (each pickled by the rank that made it).
    ``timeout`` is the parent's deadline in seconds; ``None`` sets none (a
    rank stuck in a collective still fails at ``mesh.TIMEOUT``)."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    cards = torch.cuda.device_count()
    if backend == "nccl" and n > cards:
        raise ValueError(
            f"{n} NCCL ranks need {n} cards, one a rank, and {cards} are present "
            f"(NCCL refuses two ranks on one card): start at most {cards}, or run "
            "gloo ranks on the CPU (--device cpu in the CLIs)")
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, args, n, backend, os.path.join(tmp, "store"), tmp),
            nprocs=n, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{n} rank(s) of {fn.__qualname__} ran past "
                                       f"{timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
        return [pickle.loads((Path(tmp) / f"rank{r}.pkl").read_bytes()) for r in range(n)]
