"""Start ``n`` ranks on one host and collect what each returns.

    from async_ev_cnn_torch.parallel.launch import launch
    results = launch(fn, 4, args=(x,), backend="gloo")   # fn(*args) on 4 ranks

Each rank is a process started by ``torch.multiprocessing`` (spawn: a
fresh interpreter that imports ``fn`` by its module path, so ``fn`` must
live in a module that imports neither ``jax`` nor the JAX package).  The
ranks meet at a ``FileStore`` under a temporary directory, so groups of
ranks never share a rendezvous; each rank runs on one thread.  The
parent waits at most ``timeout`` seconds: a rank that fails or outlives
it ends every rank and raises here.
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
           timeout: float = 300.0) -> list:
    """Run ``fn(*args)`` on ``n`` ranks of a ``backend`` world; returns the
    ranks' results in rank order (each pickled by the rank that made it)."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, args, n, backend, os.path.join(tmp, "store"), tmp),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} rank(s) of {fn.__qualname__} ran past "
                                       f"{timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
        return [pickle.loads((Path(tmp) / f"rank{r}.pkl").read_bytes()) for r in range(n)]
