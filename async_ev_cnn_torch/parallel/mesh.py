"""Device meshes over ``torch.distributed``: one process a device (SPMD).

Counterpart of ``make_mesh`` (``async_ev_cnn_tpu/parallel/streams.py``) and
``make_time_mesh`` (``async_ev_cnn_tpu/parallel/time_shard.py``).  The JAX
package has one controller over a ``jax.sharding.Mesh`` of every device;
here every rank is a process of its own that holds its shard, and the
collectives the JAX compiler inserts are written out (:class:`Comm`).  A
mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with the JAX
axis names: ``("data", "model")``, ``("time",)`` or ``("data", "time")``.

The backend follows the device: NCCL on ``cuda`` (the default, as for
every entry point of the port) and gloo on the CPU.  A caller may name
``backend='gloo'`` on ``cuda``: several ranks can share one card only
through gloo (NCCL refuses two ranks on one GPU).  Nothing switches the
backend or the device on its own.  Every group started here has the
timeout :data:`TIMEOUT` (read when the group starts), so a rank left
waiting in a collective fails the run.
"""

from __future__ import annotations

import contextlib
import os
from collections import Counter
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from async_ev_cnn_torch.utils.device import resolve_device

#: the timeout of every process group the port starts
TIMEOUT = timedelta(seconds=120)


def init_world(device=None, backend: str | None = None) -> torch.device:
    """Start the default process group unless one runs, and return this
    rank's device.

    With ``WORLD_SIZE`` in the environment (``torchrun``) the group comes
    from the environment's rendezvous; otherwise it is a world of 1 on a
    ``HashStore`` (the one-device deployment).  ``backend`` defaults to
    NCCL on ``cuda`` and gloo on the CPU; a group already running keeps its
    backend, and naming another raises.  On ``cuda`` the rank computes on
    card ``LOCAL_RANK`` (else its rank) modulo the cards present."""
    dev = resolve_device(device)
    if backend is not None and backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if dist.is_initialized():
        running = dist.get_backend()
        if backend is not None and backend != running:
            raise ValueError(f"the process group runs {running!r}, not {backend!r}")
        backend = running
    else:
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL runs on 'cuda' only, not on {dev.type!r}")
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, timeout=TIMEOUT)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=TIMEOUT)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


@contextlib.contextmanager
def world(device=None, backend: str | None = None):
    """:func:`init_world` for the block, which gets this rank's device; a
    process group started here ends with the block."""
    started = not dist.is_initialized()
    try:
        yield init_world(device, backend)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank of ``mesh`` computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The size of ``mesh``'s axis ``name`` (``mesh.shape[name]`` in JAX)."""
    names = mesh.mesh_dim_names or ()
    if name not in names:
        raise ValueError(f"mesh has no axis {name!r}: {names}")
    return mesh.shape[names.index(name)]


def _build(shape: tuple[int, ...], names: tuple[str, ...], dev: torch.device) -> DeviceMesh:
    """A mesh of ``shape`` over the whole (started) world, one group an
    axis line.  Every rank creates every group, in the same order, each
    with :data:`TIMEOUT` (``init_device_mesh`` would give them the
    library's default, and an axis as large as the world the default
    group's, which a caller may have started with another timeout)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh does not cover the world of "
            f"{world} rank(s)")
    ranks = torch.arange(world).reshape(shape)
    groups = []
    for dim, size in enumerate(shape):
        mine = None
        for line in ranks.movedim(dim, -1).reshape(-1, size).tolist():
            group = dist.new_group(line, timeout=TIMEOUT)
            if rank in line:
                mine = group
        groups.append(mine)
    return DeviceMesh.from_group(groups, dev.type, mesh=ranks, mesh_dim_names=names)


def make_mesh(n_data: int | None = None, n_model: int = 1, device=None,
              backend: str | None = None) -> DeviceMesh:
    """A ``(data, model)`` mesh over every rank (the JAX package's
    ``make_mesh``).  ``n_data`` defaults to the world over ``n_model``; a
    mesh that does not cover the world raises (the JAX package keeps the
    first devices; a rank left out here would wait forever)."""
    dev = init_world(device, backend)
    world = dist.get_world_size()
    if n_model < 1 or n_model > world:
        raise ValueError(f"n_model={n_model} does not fit {world} device(s)")
    if n_data is None:
        n_data = world // n_model
    if n_data < 1:
        raise ValueError(
            f"mesh would have a zero-size data axis ({world} device(s) / "
            f"n_model={n_model})")
    return _build((n_data, n_model), ("data", "model"), dev)


def make_time_mesh(n_devices: int | None = None, n_streams: int = 1, device=None,
                   backend: str | None = None) -> DeviceMesh:
    """A ``(time,)`` mesh, or a ``(data, time)`` mesh of ``n_streams`` data
    shards when ``n_streams > 1`` (the JAX package's ``make_time_mesh``)."""
    dev = init_world(device, backend)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"requested {n} devices but only {world} available")
    if n_streams > 1:
        if n % n_streams:
            raise ValueError(f"{n} devices not divisible by {n_streams} stream shards")
        return _build((n_streams, n // n_streams), ("data", "time"), dev)
    return _build((n,), ("time",), dev)


class Comm:
    """The collectives of one mesh axis, as the layers need them, and a
    count of the calls by ``(op, shape, dtype)`` (:attr:`calls`).

    A gloo group takes CPU tensors (gloo's CUDA support differs between
    collectives and builds), so on a gloo group a tensor on the card goes
    through the host and back; that is the backend's rule, not a retry."""

    def __init__(self, group, device: torch.device):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = device
        self.staged = device.type == "cuda" and dist.get_backend(group) == "gloo"
        self.calls: Counter = Counter()

    def _src(self, x: torch.Tensor) -> torch.Tensor:
        return x.detach().cpu() if self.staged else x.detach().to(self.device).contiguous()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[size, *x.shape]``: every rank's ``x`` in rank order, on
        ``x``'s device."""
        self.calls["all_gather", tuple(x.shape), str(x.dtype)] += 1
        src = self._src(x)
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.group)
        return torch.stack(out).to(x.device)

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        src = self._src(x).clone()
        dist.all_reduce(src, op=op, group=self.group)
        return src.to(x.device)

    def any(self, mask: torch.Tensor) -> torch.Tensor:
        """The elementwise OR of every rank's bool ``mask``."""
        self.calls["any", tuple(mask.shape), str(mask.dtype)] += 1
        return self._all_reduce(mask.to(torch.uint8), dist.ReduceOp.MAX).bool()

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of every rank's ``x``."""
        self.calls["sum", tuple(x.shape), str(x.dtype)] += 1
        return self._all_reduce(x, dist.ReduceOp.SUM)
