"""Multi-stream serving over a ``(data, model)`` mesh.

Counterpart of ``async_ev_cnn_tpu/parallel/streams.py``, one process a
device: every rank holds ``n_streams / n_data`` whole streams (axis
``data``; streams are independent, so nothing crosses it while they run)
and, over axis ``model``, its share of every conv's output channels.  The
shardings are the JAX package's (``param_shardings``, ``state_shardings``,
``chunk_sharding``):

* weights replicated over ``data``; each conv's kernel and bias split on
  the output channel (OIHW axis 0) over ``model``, in GSPMD's uneven
  shares where ``n_model`` does not divide the count (the eFCN's conv7
  has 110: ``ceil(110 / n)`` a rank, the last rank the rest); the fc tail
  replicated;
* stream state and chunks split on the stream axis over ``data``; an
  incremental conv's state split on its channel axis over ``model``, a
  pool's ``idx_max`` too and its ``recompute`` replicated.

Where the JAX compiler inserts collectives for the ``model`` axis, the
rank's network (:class:`ChannelShardedNetwork`) makes them around the
layer calls: an all_gather of the planes a conv reads (and of the
featuremap before the dense tail), and an OR of the masks that reduce
over channels, the conv's ``changed`` and the pool's ``recompute``.
``active`` is replicated, so the OR of the rank-local ``changed | active``
and ``recompute`` is the global mask.

Global inputs (:meth:`MultiStreamEngine.init_states`, ``place_params``,
``place_chunks``) are the same host or CPU arrays on every rank, which
copies only its shard to its device.  Each call returns the rank's shard
of the outputs; :meth:`MultiStreamEngine.gather` assembles the global
array, the host view of the JAX package's global array.
"""

from __future__ import annotations

import torch

from async_ev_cnn_torch.layers.network import RVT_KINDS, EventNetwork, LayerDef
from async_ev_cnn_torch.layers.types import EventChunk, LayerIO
from async_ev_cnn_torch.parallel.mesh import Comm, axis_size, mesh_device


def channel_share(total: int, n: int, i: int) -> slice:
    """Rank ``i``'s channels of ``total`` split ``n`` ways as GSPMD splits
    them: ``ceil(total / n)`` a rank, the last ranks the rest (possibly
    none)."""
    chunk = -(-total // n)
    lo = min(i * chunk, total)
    return slice(lo, min(lo + chunk, total))


def gather_channels(comm: Comm, x: torch.Tensor, total: int, dim: int) -> torch.Tensor:
    """Every rank's share of ``total`` channels along ``dim`` (negative),
    in rank order: each share padded to ``ceil(total / n)`` for the
    all_gather, the padding dropped after."""
    chunk = -(-total // comm.size)
    pad = chunk - x.shape[dim]
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=dim)
    parts = comm.all_gather(x).unbind(0)
    return torch.cat(parts, dim=dim).narrow(dim, 0, total)


class ChannelShardedNetwork(EventNetwork):
    """``net`` run over one ``model`` rank's output channels of every conv
    (its params are the rank's shares, :meth:`MultiStreamEngine.
    place_params`), with the collectives of ``comm`` where a layer needs
    the other ranks' channels.  The layers are ``net``'s own objects."""

    def __init__(self, net: EventNetwork, comm: Comm):
        self.__dict__.update(net.__dict__)
        self._comm = comm
        # a conv after the first reads a predecessor's split channels; the
        # first reads the integration layer's surface, which every rank holds
        convs = [ld.name for ld in net.event_layers if ld.kind == "conv"]
        self._split_input = frozenset(convs[1:])

    def _conv_input(self, ld: LayerDef, io: LayerIO) -> LayerIO:
        if ld.name not in self._split_input:
            return io
        c = ld.spec.in_shape[0]
        cact = io.conv_actfn
        return LayerIO(
            surface=gather_channels(self._comm, io.featuremap, c, -3), layer_actfn=None,
            conv_actfn=None if cact is None else gather_channels(self._comm, cact, c, -3),
            mask=io.mask)

    def _layer_output(self, ld: LayerDef, state, io: LayerIO):
        if ld.spec.mode == "full":
            return state, io
        if ld.kind == "conv":  # changed (over channels) | active
            return state, io._replace(mask=self._comm.any(io.mask))
        return state._replace(recompute=self._comm.any(state.recompute)), io

    def apply_tail(self, params, featuremap_hwc: torch.Tensor) -> torch.Tensor:
        x = gather_channels(self._comm, featuremap_hwc, self.out_shape[0], -1)
        return super().apply_tail(params, x)


def stream_state(states: tuple, s: int) -> tuple:
    """Stream ``s`` of a state whose leaves carry a leading stream axis."""
    return tuple(type(st)(*(f[s] for f in st)) for st in states)


def stack_states(states: list) -> tuple:
    """Per-stream states stacked on a leading stream axis."""
    return tuple(type(parts[0])(*(torch.stack(f) for f in zip(*parts)))
                 for parts in zip(*states))


class MultiStreamEngine:
    """Independent event streams over a ``(data, model)`` mesh: this rank's
    ``n_streams / n_data`` streams, with a leading stream axis on every
    state leaf and chunk plane, and its share of the conv channels."""

    def __init__(self, net: EventNetwork, mesh):
        self.mesh = mesh
        self.device = mesh_device(mesh)
        self.n_data = axis_size(mesh, "data")
        self.n_model = axis_size(mesh, "model")
        self.data_index = mesh.get_local_rank("data")
        self.model_index = mesh.get_local_rank("model")
        #: the collectives over ``data`` (outputs) and ``model`` (layers)
        self.data = Comm(mesh.get_group("data"), self.device)
        self.model = Comm(mesh.get_group("model"), self.device)
        rvt = [ld.name for ld in net.event_layers if ld.kind in RVT_KINDS]
        if rvt and self.n_model > 1:
            raise ValueError(f"the model axis shards conv channels; layers {rvt} are not "
                             "sharded: serve such a network on a mesh of 'data' alone")
        #: the network this rank runs (``net`` itself when ``n_model == 1``)
        self.net = net if self.n_model == 1 else ChannelShardedNetwork(net, self.model)
        self._full_net = net

    # ---- shards -----------------------------------------------------------

    def streams(self, n_streams: int) -> slice:
        """This rank's streams of ``n_streams``."""
        if n_streams % self.n_data:
            raise ValueError(
                f"n_streams={n_streams} must be divisible by the mesh's data "
                f"axis ({self.n_data})")
        local = n_streams // self.n_data
        return slice(self.data_index * local, (self.data_index + 1) * local)

    def _channels(self, total: int) -> slice:
        return channel_share(total, self.n_model, self.model_index)

    def place_params(self, params) -> dict:
        """This rank's weights on its device, from the global params (the
        port's layout: OIHW conv kernels): each conv's share of the output
        channels, the rest whole."""
        out = {}
        for k, v in params.items():
            v = torch.as_tensor(v)
            if k.startswith(("w_conv", "b_conv")):
                v = v[self._channels(v.shape[0])]
            out[k] = v.to(self.device, copy=True)
        return out

    def place_state(self, states: tuple) -> tuple:
        """This rank's shard of a global stream-batched state (every leaf
        ``[S, ...]``): its streams, and over ``model`` its channels of the
        incremental convs' state and of the pools' ``idx_max``."""
        rows = self.streams(states[0].surface.shape[0])
        out = []
        for ld, st in zip(self._full_net.event_layers, states):
            st = type(st)(*(torch.as_tensor(f)[rows].to(self.device, copy=True)
                            for f in st))
            if ld.kind == "conv" and ld.spec.mode != "full":
                ch = self._channels(ld.spec.out_channels)
                st = type(st)(*(f[:, ch].contiguous() for f in st))
            elif ld.kind == "pool" and ld.spec.mode != "full":
                ch = self._channels(ld.spec.out_shape[0])
                st = st._replace(idx_max=st.idx_max[:, ch].contiguous())
            out.append(st)
        return tuple(out)

    def init_states(self, params, n_streams: int) -> tuple:
        """The initial state of ``n_streams`` streams (the same for each),
        this rank's shard of it; ``params`` are the global weights."""
        self.streams(n_streams)  # the real constraint, before any work
        full = {k: torch.as_tensor(v).to(self.device) for k, v in params.items()}
        base = self._full_net.init_state(full, self.device)
        batched = tuple(type(st)(*(f.expand(n_streams, *f.shape) for f in st))
                        for st in base)
        return self.place_state(batched)

    def place_chunks(self, chunks: EventChunk, leading_time: bool = False) -> EventChunk:
        """This rank's streams of global chunks ``[S, E]`` (``[T, S, E]``
        with ``leading_time``) on its device."""
        ax = int(leading_time)
        rows = self.streams(chunks.y.shape[ax])
        return EventChunk(*(torch.as_tensor(f).narrow(ax, rows.start, rows.stop - rows.start)
                            .to(self.device, copy=True) for f in chunks))

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Every ``data`` rank's shard of ``x`` concatenated along the
        stream axis ``dim`` (1 in ``[T, S, ...]`` outputs, 0 in ``[S, ...]``
        state): the global array.  A collective: every rank calls it."""
        return torch.cat(self.data.all_gather(x).unbind(0), dim=dim)

    # ---- compute ------------------------------------------------------------

    def step(self, params, states: tuple, chunks: EventChunk):
        """One chunk for every stream of the rank: ``chunks`` leaves are
        ``[S_local, E]``; returns ``(states, outputs [S_local, ...])``."""
        outs, new = [], []
        for s in range(chunks.y.shape[0]):
            st, out = self.net.step(params, stream_state(states, s),
                                    EventChunk(*(f[s] for f in chunks)))
            new.append(st)
            outs.append(out)
        return stack_states(new), torch.stack(outs)

    def scan(self, params, states: tuple, chunks: EventChunk):
        """T chunks for every stream of the rank, each stream through
        :meth:`EventNetwork.scan`: ``chunks`` leaves are ``[T, S_local, E]``;
        returns ``(states, outputs [T, S_local, ...])``."""
        outs, new = [], []
        for s in range(chunks.y.shape[1]):
            st, out = self.net.scan(params, stream_state(states, s),
                                    EventChunk(*(f[:, s] for f in chunks)))
            new.append(st)
            outs.append(out)
        return stack_states(new), torch.stack(outs, dim=1)

    def scan_parallel(self, params, states: tuple, chunks: EventChunk,
                      window: int | None = 256):
        """Parallel-in-time serving of the rank's streams: one
        :meth:`EventNetwork.scan_parallel` call on ``[S_local, T, E]`` (its
        stream axis: one K1 call a window whatever ``S_local``).  Requires
        an all-'full' network; ``chunks`` leaves are ``[T, S_local, E]``;
        returns ``(states, outputs [T, S_local, ...])``.  ``window`` caps
        the chunks a stream of one window."""
        ste = EventChunk(*(f.transpose(0, 1).contiguous() for f in chunks))
        states, outs = self.net.scan_parallel(params, states, ste, window=window)
        return states, outs.transpose(0, 1)
