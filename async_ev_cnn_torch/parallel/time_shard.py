"""Sequence parallelism over one stream's chunk axis.

Counterpart of ``async_ev_cnn_tpu/parallel/time_shard.py`` (its docstring
has the derivation), one process a device.  Each chunk's surface update
is the max-plus affine map ``g[b, c](s) = max(s + b, c)``, closed under
composition (:mod:`async_ev_cnn_torch.ops.integrate`), so D ranks each take
``T / D`` of a stream's chunks and:

1. find the global timestamp chain: an all_gather of one int32 maximum a
   rank;
2. build their local ``(b, c)`` pairs (``chunk_affine_updates``) and scan
   them with ``associative_scan`` (``lax.associative_scan``'s grouping,
   so the bits are the JAX package's);
3. make one collective round, an all_gather of the ``(b, c)`` totals
   (``2 * C*H*W`` floats a stream, about 287 KB at the eFCN's 160x224),
   and compose them in the JAX package's static D-step order into their
   exclusive prefix and the full composition;
4. run the time-batched network forward on their local surfaces.

The traffic is O(D * C*H*W) a dispatch whatever T.  The state comes out
the same on every rank (the full composition applied to the initial
surface), the JAX package's replication invariant, which its
``check_vma=False`` does not check and the port's tests do.  With
``stream_axis='data'`` (a ``(data, time)`` mesh from ``make_time_mesh``)
the streams shard over ``data`` too (dp x sp), and the collectives ride
``time`` only, one call for all of a rank's streams.
"""

from __future__ import annotations

import torch

from async_ev_cnn_torch.layers.network import EventNetwork
from async_ev_cnn_torch.layers.types import EventChunk, IntegrationState
from async_ev_cnn_torch.ops.integrate import (
    associative_scan,
    chunk_affine_updates,
    maxplus_combine,
)
from async_ev_cnn_torch.ops.surface_scan import TS_SENTINEL_VALUE
from async_ev_cnn_torch.parallel.mesh import Comm, axis_size, mesh_device


class TimeShardEngine:
    """Shards one stream's chunk axis over the mesh axis ``axis`` (and, with
    ``stream_axis``, a leading stream axis over that one).  Requires an
    all-'full' network, as ``EventNetwork.scan_parallel`` does."""

    def __init__(self, net: EventNetwork, mesh, axis: str = "time",
                 stream_axis: str | None = None):
        if not net.is_all_full:
            raise ValueError(
                "time sharding requires conv_mode='full' for every layer "
                "(same precondition as scan_parallel)")
        names = mesh.mesh_dim_names or ()
        for name in (axis, stream_axis):
            if name is not None and name not in names:
                raise ValueError(f"mesh has no axis {name!r}: {names}")
        self.net = net
        self.mesh = mesh
        self.device = mesh_device(mesh)
        self.axis = axis
        self.stream_axis = stream_axis
        #: the collectives over the time axis (the prefix composition)
        self.time = Comm(mesh.get_group(axis), self.device)
        self.data = (Comm(mesh.get_group(stream_axis), self.device)
                     if stream_axis is not None else None)
        self.n_streams_axis = 1 if stream_axis is None else axis_size(mesh, stream_axis)

    def _local(self, params, state, surf, prev_ts, chunks: EventChunk):
        """One rank's share: ``surf`` ``[S, C, H, W]``, ``prev_ts`` ``[S]``,
        ``chunks`` ``[S, T/D, E]``; returns the final ``(surface, prev_ts)``
        and the outputs ``[S, T/D, ...]``."""
        comm, d, idx = self.time, self.time.size, self.time.rank
        leak = self.net.event_layers[0].spec.leak
        channels, h, w = surf.shape[-3:]

        # -- the global timestamp chain (exact integer maxima)
        chunk_max = torch.where(chunks.valid, chunks.ts.to(torch.int32),
                                TS_SENTINEL_VALUE).amax(dim=-1)  # [S, T/D]
        dev_max = comm.all_gather(chunk_max.amax(dim=-1))  # [D, S]
        before = (torch.arange(d, device=surf.device) < idx)[:, None]
        incoming = torch.maximum(prev_ts, torch.where(before, dev_max, TS_SENTINEL_VALUE)
                                 .amax(dim=0))

        # -- local coefficients and their prefix scan, [T/D, S, C, H, W]
        pairs = [chunk_affine_updates(channels, h, w, incoming[s],
                                      EventChunk(*(f[s] for f in chunks)), leak)
                 for s in range(surf.shape[0])]
        b = torch.stack([p[0] for p in pairs], dim=1)
        c = torch.stack([p[1] for p in pairs], dim=1)
        big_b, big_c = associative_scan(maxplus_combine, (b, c))

        # -- one collective round: the device totals, composed in the JAX
        #    package's static order into this rank's exclusive prefix
        #    (devices < idx) and the full composition
        tot_b, tot_c = comm.all_gather(big_b[-1]), comm.all_gather(big_c[-1])
        excl = full = (torch.zeros_like(big_b[-1]), torch.full_like(big_c[-1], -torch.inf))
        for j in range(d):
            full = maxplus_combine(full, (tot_b[j], tot_c[j]))
            if j < idx:
                excl = full

        glob_b, glob_c = maxplus_combine(excl, (big_b, big_c))
        surfaces = torch.maximum(surf[None] + glob_b, glob_c).transpose(0, 1)
        final_surface = torch.maximum(surf + full[0], full[1])
        final_ts = torch.maximum(prev_ts, dev_max.amax(dim=0))

        outs = self.net.full_frame_forward(params, state, surfaces.flatten(0, 1))
        return final_surface, final_ts, outs.unflatten(0, surfaces.shape[:2])

    def scan_parallel(self, params, state: tuple, chunks: EventChunk):
        """Time-sharded parallel-in-time execution on global inputs (the
        same on every rank).

        Single-stream engine: ``chunks`` leaves are ``[T, E]`` with T
        divisible by the time axis; returns the new state (the same on
        every rank) and this rank's outputs ``[T/D, ...]``.  dp x sp: state
        leaves ``[S, ...]`` and chunks ``[S, T, E]``, S divisible by the
        stream axis; returns this rank's streams' state ``[S/Ds, ...]`` and
        outputs ``[S/Ds, T/D, ...]``.  :meth:`gather` assembles the global
        outputs, which match ``EventNetwork.scan_parallel`` (per stream) up
        to float regrouping (~1e-6)."""
        streams = self.stream_axis is not None
        d = self.time.size
        t = chunks.y.shape[int(streams)]
        # every rank checks the same global shapes before any collective
        if t % d:
            raise ValueError(f"T={t} not divisible by time-axis size {d}")
        if streams and chunks.y.shape[0] % self.n_streams_axis:
            raise ValueError(f"S={chunks.y.shape[0]} not divisible by stream-axis "
                             f"size {self.n_streams_axis}")
        t_local = t // d
        t0 = self.time.rank * t_local
        dev = self.device
        if streams:
            s_local = chunks.y.shape[0] // self.n_streams_axis
            rows = slice(self.data.rank * s_local, (self.data.rank + 1) * s_local)
            state = tuple(type(st)(*(torch.as_tensor(f)[rows].to(dev) for f in st))
                          for st in state)
            local = EventChunk(*(torch.as_tensor(f)[rows, t0:t0 + t_local].to(dev)
                                 for f in chunks))
            surf, prev_ts = state[0]
        else:
            state = tuple(type(st)(*(torch.as_tensor(f).to(dev) for f in st))
                          for st in state)
            local = EventChunk(*(torch.as_tensor(f)[None, t0:t0 + t_local].to(dev)
                                 for f in chunks))
            surf, prev_ts = state[0].surface[None], state[0].prev_ts[None]
        surf_out, ts_out, outs = self._local(params, state, surf, prev_ts.to(torch.int32),
                                             local)
        if not streams:
            surf_out, ts_out, outs = surf_out[0], ts_out[0], outs[0]
        return (IntegrationState(surf_out, ts_out),) + tuple(state[1:]), outs

    def gather(self, outs: torch.Tensor) -> torch.Tensor:
        """Every rank's outputs assembled: ``[T, ...]``, or ``[S, T, ...]``
        for dp x sp.  A collective: every rank calls it."""
        t_dim = 0 if self.stream_axis is None else 1
        outs = torch.cat(self.time.all_gather(outs).unbind(0), dim=t_dim)
        return outs if self.data is None else self.gather_streams(outs)

    def gather_streams(self, x: torch.Tensor) -> torch.Tensor:
        """dp x sp: every ``stream_axis`` rank's streams of ``x`` (leading
        stream axis), in order."""
        return torch.cat(self.data.all_gather(x).unbind(0), dim=0)
