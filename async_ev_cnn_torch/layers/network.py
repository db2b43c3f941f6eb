"""Network assembly: chain event layers from a layer-DSL dict, plus the
dense frame oracle over the same specs.

Counterpart of ``async_ev_cnn_tpu/layers/network.py``.  The layer DSL and
its name-matching contract are the same (``'conv' in name`` / ``'pool' in
name``, ``fc``/``flatten`` deferred to a dense tail).  Parameters are the
port's: ``w_<name>`` conv kernels in OIHW (the checkpoint's HWIO kernels
are transposed once by :func:`async_ev_cnn_torch.utils.weights.
params_from_jax`), ``b_<name>`` biases, fc weights as in the checkpoint.

Two engines run the same streaming semantics: the sequential one
(:meth:`EventNetwork.forward`/``step``/``scan``, every conv mode, each layer
carrying its state from chunk to chunk and recomputing only the sites that
events reach), and the parallel-in-time one (:meth:`EventNetwork.
scan_parallel`, every conv/pool layer in 'full' mode).

The port's DSL also describes a small graph, such as YOLOv3-tiny's
(``utils/config``): ``route``, ``upsample`` and ``yolo`` layers, pools
whose stride is below their size, and linear convs.  Only the parallel
engine runs such a network (every layer 'full'): the sequential engine
propagates events along a chain.  It then returns one grid per ``yolo``
layer.
"""

from __future__ import annotations

import copy
from collections import Counter, OrderedDict
from math import prod
from typing import Any, NamedTuple

import torch

from async_ev_cnn_torch.layers import conv_stack
from async_ev_cnn_torch.layers.conv2d import ConvSpec, conv_init, conv_step
from async_ev_cnn_torch.layers.integration import (
    IntegrationSpec,
    integration_init,
    integration_step,
)
from async_ev_cnn_torch.layers.maxpool import PoolSpec, pool_init, pool_step
from async_ev_cnn_torch.layers.types import (
    ConvState,
    EventChunk,
    IntegrationState,
    LayerIO,
    PoolState,
)
from async_ev_cnn_torch.ops import stem
from async_ev_cnn_torch.ops.conv import conv2d_dense, leaky, matmul_precision
from async_ev_cnn_torch.ops.integrate import integrate_parallel
from async_ev_cnn_torch.ops.pool import maxpool_dense
from async_ev_cnn_torch.utils.device import resolve_device
from async_ev_cnn_torch.utils.profiling import span


class LayerDef(NamedTuple):
    # 'intgr' | 'conv' | 'pool' | 'route' | 'upsample' | 'yolo' | 'fc' | 'flatten'
    kind: str
    name: str
    spec: Any


class RouteSpec(NamedTuple):
    """The output of earlier layers: one, or several concatenated over
    channels in the order given (darknet's ``route``)."""

    sources: tuple[str, ...]
    out_shape: tuple[int, int, int]
    mode: str = "full"


class UpsampleSpec(NamedTuple):
    """Nearest-neighbour upsampling by ``factor`` (darknet's ``upsample``)."""

    in_shape: tuple[int, int, int]
    factor: int
    mode: str = "full"

    @property
    def out_shape(self) -> tuple[int, int, int]:
        c, h, w = self.in_shape
        return (c, h * self.factor, w * self.factor)


class YoloSpec(NamedTuple):
    """A detection head: the grid of layer ``source`` is a network output."""

    source: str
    out_shape: tuple[int, int, int]
    mode: str = "full"


#: the layer kinds that only the parallel engine's graph walk runs
GRAPH_KINDS = ("route", "upsample", "yolo")


def build_layer_defs(
    layer_defs: "OrderedDict[str, list[int]]",
    frame_h: int,
    frame_w: int,
    leak: float,
    alpha: float,
    padding: str,
    conv_mode: str = "dense",
    capacity_frac: float = 0.25,
    window_frac: float = 0.25,
    activation_dtype: str = "float32",
) -> tuple[list[LayerDef], list[LayerDef]]:
    """Returns ``(event_layers, dense_tail)``, as the JAX package does.

    A ``route``, ``upsample`` or ``yolo`` layer, a pool whose stride is
    below its size or a linear conv (module docstring) needs every layer
    'full', and a network with ``yolo`` layers no dense tail."""
    modes = ("auto", "dense", "sparse", "sparse_pallas", "sparse_rows", "window", "full")
    if conv_mode not in modes:
        raise ValueError(f"conv_mode must be one of {modes}, got {conv_mode!r}")
    if activation_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"activation_dtype must be 'float32' or 'bfloat16', got "
            f"{activation_dtype!r}"
        )
    # surface channel count follows the first conv's input channels:
    # 1 = polarity dropped (reference behavior), 2 = ON/OFF channels.
    first_conv_cin = next(
        (size[2] for name, size in layer_defs.items() if "conv" in name), 1
    )
    if first_conv_cin not in (1, 2):
        raise ValueError(
            f"first conv in_channels must be 1 or 2 (surface channels), "
            f"got {first_conv_cin}"
        )
    intgr = IntegrationSpec(leak=leak, h=frame_h, w=frame_w, channels=first_conv_cin)
    event_layers = [LayerDef("intgr", "intgr", intgr)]
    tail: list[LayerDef] = []
    prev_shape = intgr.out_shape
    # once a layer runs in 'full' mode its conv-actfn and active-site mask
    # are no longer maintained, so every layer downstream is 'full' too
    force_full = False
    layer_modes = getattr(layer_defs, "modes", {})
    linear = getattr(layer_defs, "linear", set())
    shapes = {}  # each layer's output shape, for the layers that name it
    graph = []  # the layers that need every layer 'full'

    def named(name, sources):
        missing = [s for s in sources if s not in shapes]
        if missing or not sources:
            raise ValueError(f"layer {name}: no earlier layer named {missing or sources}")
        return [shapes[s] for s in sources]

    for name, size in layer_defs.items():
        if "route" in name:
            parts = named(name, size)
            if len({p[1:] for p in parts}) > 1:
                raise ValueError(f"layer {name}: routed maps differ in size: {parts}")
            spec = RouteSpec(tuple(size), (sum(p[0] for p in parts), *parts[0][1:]))
            event_layers.append(LayerDef("route", name, spec))
            prev_shape = spec.out_shape
            graph.append(name)
        elif "upsample" in name:
            spec = UpsampleSpec(prev_shape, int(size[0]))
            event_layers.append(LayerDef("upsample", name, spec))
            prev_shape = spec.out_shape
            graph.append(name)
        elif "yolo" in name:
            if len(size) != 1:
                raise ValueError(f"layer {name}: a yolo layer names one layer, got {size}")
            spec = YoloSpec(size[0], named(name, size)[0])
            event_layers.append(LayerDef("yolo", name, spec))
            graph.append(name)
        elif "conv" in name:
            kh, kw, cin, cout = size
            if cin != prev_shape[0]:
                raise ValueError(
                    f"layer {name}: in_channels {cin} != previous out_channels {prev_shape[0]}"
                )
            explicit = name in layer_modes
            layer_mode = layer_modes.get(name, conv_mode)
            if layer_mode not in modes:
                raise ValueError(f"layer {name}: unknown conv mode {layer_mode!r}")
            if force_full:
                if explicit and layer_mode not in ("full", "auto"):
                    raise ValueError(
                        f"layer {name}: explicit mode {layer_mode!r} cannot "
                        "follow a 'full' layer — 'full' stops maintaining "
                        "the active-site mask and conv-actfn that every "
                        "incremental mode needs (put incremental layers "
                        "before the first @full layer)"
                    )
                mode = "full"
            elif layer_mode == "auto":
                # 'auto' is 'full' in the JAX package, from its TPU
                # measurements; the H100 default stays open until measured
                mode = "full"
            else:
                mode = layer_mode
            force_full = force_full or mode == "full"
            if name in linear:
                graph.append(name)
            spec = ConvSpec(
                in_shape=prev_shape,
                out_channels=cout,
                ksize=(kh, kw),
                stride=1,
                # leaky at alpha 1 is the identity, exactly
                alpha=1.0 if name in linear else alpha,
                padding=padding,
                mode=mode,
                capacity_frac=capacity_frac,
                window_frac=window_frac,
                act_dtype=activation_dtype if mode == "full" else "float32",
            )
            event_layers.append(LayerDef("conv", name, spec))
            prev_shape = spec.out_shape
        elif "pool" in name:
            # 'poolN=kh,kw' strides by kh; 'poolN=kh,kw,s' by s, and a stride
            # below the window pads as TF 'SAME' (PoolSpec.padding)
            spec = PoolSpec(
                in_shape=prev_shape, ksize=tuple(size[:2]),
                stride=size[2] if len(size) > 2 else size[0],
                mode="full" if force_full else "event",
                act_dtype=activation_dtype if force_full else "float32",
            )
            if spec.padding == "SAME":
                graph.append(name)
            event_layers.append(LayerDef("pool", name, spec))
            prev_shape = spec.out_shape
        elif "fc" in name:
            tail.append(LayerDef("fc", name, tuple(size)))
        elif "flatten" in name:
            tail.append(LayerDef("flatten", name, None))
        else:
            raise ValueError(f"unknown layer kind in name {name!r}")
        shapes[name] = prev_shape
    incremental = [ld.name for ld in event_layers[1:]
                   if ld.kind in ("conv", "pool") and ld.spec.mode != "full"]
    if graph and incremental:
        raise ValueError(
            f"layers {graph} (route, upsample, yolo, an overlapping pool or a "
            "linear conv) need every layer 'full': the incremental modes "
            f"propagate events along a chain, and {incremental} are not 'full'")
    if tail and any(ld.kind == "yolo" for ld in event_layers):
        raise ValueError("a network with yolo layers takes no fc/flatten tail")
    return event_layers, tail


def needs_grad(frame: torch.Tensor, params) -> bool:
    """Whether a forward of ``frame`` with ``params`` builds a graph for
    autograd: grad mode is on and the frame or a parameter requires grad."""
    return torch.is_grad_enabled() and (
        frame.requires_grad or any(getattr(p, "requires_grad", False)
                                   for p in params.values()))


def _validate_stem_fusion(stem_fusion):
    """Identity checks, as in the JAX package (1 == True must not pass)."""
    if not (stem_fusion is True or stem_fusion is False
            or stem_fusion == "auto"):
        raise ValueError(
            f"stem_fusion must be True, False or 'auto', got {stem_fusion!r}")


class EventNetwork:
    """The async event network: static specs + init/forward over explicit
    state (a tuple of per-layer ``NamedTuple``s of tensors).

    ``conv_mode`` takes the JAX package's names, so configurations read the
    same: 'dense', 'sparse', 'sparse_pallas', 'sparse_rows', 'window',
    'full' and 'auto' (= 'full').  'sparse_pallas' runs the hand-written
    CUDA rulebook kernels (K3 at stride 1, K4 otherwise) on the card, and
    their plain versions on the CPU (:mod:`async_ev_cnn_torch.layers.conv2d`).

    ``stem_fusion`` (``'auto'``, ``True`` or ``False``) decides whether the
    parallel path runs a stem conv+pool pair as one space-to-depth conv
    (:mod:`async_ev_cnn_torch.ops.stem`), by the JAX package's predicate
    (:meth:`_fusion_active`).  ``activation_dtype='bfloat16'`` stores the
    activated maps of the 'full' layers in bf16 between layers; the
    incremental layers stay float32.
    """

    def __init__(
        self,
        layer_defs: "OrderedDict[str, list[int]]",
        frame_h: int,
        frame_w: int,
        leak: float,
        alpha: float = 0.1,
        padding: str = "VALID",
        conv_mode: str = "dense",
        capacity_frac: float = 0.25,
        window_frac: float = 0.25,
        stem_fusion: bool | str = "auto",
        activation_dtype: str = "float32",
    ):
        _validate_stem_fusion(stem_fusion)
        self.event_layers, self.dense_tail = build_layer_defs(
            layer_defs, frame_h, frame_w, leak, alpha, padding,
            conv_mode, capacity_frac, window_frac, activation_dtype,
        )
        self.alpha = alpha
        self.out_shape = self.event_layers[-1].spec.out_shape
        self._stem_fusion = stem_fusion
        self._act_dtype = activation_dtype
        # the outputs that a later route or head reads: the parallel walk
        # keeps them until it returns
        self._keep = frozenset(
            src for ld in self.event_layers if ld.kind in ("route", "yolo")
            for src in (ld.spec.sources if ld.kind == "route" else (ld.spec.source,)))
        #: the yolo layers, whose grids the parallel engine returns in order
        self.heads = tuple(ld.name for ld in self.event_layers if ld.kind == "yolo")
        #: whether only the parallel engine's graph walk runs the network
        self.is_graph = bool(getattr(layer_defs, "linear", None)) or any(
            ld.kind in GRAPH_KINDS or ld.kind == "pool" and ld.spec.padding == "SAME"
            for ld in self.event_layers)
        # conv+pool pairs the parallel path MAY run as one space-to-depth
        # conv: indices into event_layers[1:] of the conv whose following
        # pool could fold in; whether they fuse is _fusion_active's call.
        # A conv whose own output is kept is not fused: the pair never
        # stores it
        self._s2d_pairs = frozenset(
            i for i, (c, p) in enumerate(zip(self.event_layers[1:], self.event_layers[2:]))
            if c.kind == "conv" and p.kind == "pool" and c.name not in self._keep
            and stem.s2d_pair_applicable(c.spec, p.spec) and stem.s2d_pair_wins(c.spec))
        #: the conv stack's plans (``layers.conv_stack.plan``), by device
        #: type, grad and fusion
        self._plans: dict = {}
        #: per conv layer of the sequential engine: host reads of device
        #: flags (``host_syncs``), ``dense_fallbacks`` and
        #: ``kernel_launches`` since the last :meth:`reset_counts`
        self.layer_counts: dict[str, Counter] = {
            ld.name: Counter() for ld in self.event_layers if ld.kind == "conv"}
        #: each layer's span name, ``layer.<name>``
        self._spans = {ld.name: f"layer.{ld.name}" for ld in self.event_layers}
        #: chunks through :meth:`step`: the request number of its spans
        self._steps = 0

    def reset_counts(self) -> None:
        for c in self.layer_counts.values():
            c.clear()

    def with_stem_fusion(self, stem_fusion: bool | str) -> "EventNetwork":
        """A shallow clone with a different ``stem_fusion`` policy."""
        _validate_stem_fusion(stem_fusion)
        clone = copy.copy(self)
        clone._stem_fusion = stem_fusion
        return clone

    def _fusion_active(self) -> bool:
        """Whether the candidate ``_s2d_pairs`` fuse, read at each call:
        the JAX package's predicate over the tier,
        ``ops.stem.allow_demoted_precision`` and the activation dtype.
        ``True`` fuses at ``highest``, and at a demoted tier while
        ``allow_demoted_precision`` stands; ``'auto'`` fuses only at the
        ``default`` tier with float32 activations (the cell where the
        fusion measured a win on the TPU; its H100 default is open);
        ``False`` never fuses."""
        prec = matmul_precision()
        if self._stem_fusion is True:
            return prec == "highest" or stem.allow_demoted_precision
        if self._stem_fusion == "auto":
            return (prec == "default" and stem.allow_demoted_precision
                    and self._act_dtype == "float32")
        return False

    # ---- memory model for the parallel-in-time path ---------------------

    def parallel_live_bytes_per_chunk(self) -> int:
        """Estimated live device bytes per time-batched chunk in
        :meth:`scan_parallel`: the widest adjacent producer/consumer
        activation pair plus two surface-sized arrays of the integrate
        front half (the same model as the JAX package).  In a graph each
        pair also holds the outputs kept for a later route or head, from
        the layer that makes one to the walk's end; a head's grid is its
        source's kept map."""
        ispec = self.event_layers[0].spec
        surface_px = ispec.channels * ispec.h * ispec.w
        prev, prev_kept, kept, peak_pair = surface_px, False, 0, 0
        for ld in self.event_layers[1:]:
            if ld.kind == "yolo":
                continue
            out = int(prod(ld.spec.out_shape))
            # the input, unless it is kept already, the output and the kept maps
            peak_pair = max(peak_pair, (0 if prev_kept else prev) + out + kept)
            prev, prev_kept = out, ld.name in self._keep
            kept += out if prev_kept else 0
        return 4 * (2 * surface_px + peak_pair)

    def auto_window(self, t: int, budget_mb: float) -> int | None:
        """Largest time window whose estimated peak activation memory fits
        ``budget_mb`` (2x safety factor); ``None`` when all ``t`` fit."""
        per = 2 * self.parallel_live_bytes_per_chunk()
        w = int(budget_mb * 2**20 // per)
        w = max(1, w - w % 8 if w >= 8 else w)
        return None if w >= t else w

    @property
    def is_all_full(self) -> bool:
        """True when every conv/pool layer runs in 'full' (recompute) mode —
        the precondition for the parallel-in-time path."""
        return all(
            getattr(ld.spec, "mode", None) == "full"
            for ld in self.event_layers[1:]
        )

    # ---- the model axis -------------------------------------------------
    # Identities here.  ``parallel.streams`` runs a network over one rank's
    # share of every conv's output channels and overrides them with the
    # collectives that such a rank needs around the layer calls.

    def _conv_input(self, ld: LayerDef, io: LayerIO) -> LayerIO:
        """The predecessor's output as conv ``ld`` reads it."""
        return io

    def _layer_output(self, ld: LayerDef, state, io: LayerIO):
        """A sequential layer's new state and output as the next layer
        and the next chunk read them."""
        return state, io

    # ---- state ----------------------------------------------------------

    def init_state(self, params, device=None) -> tuple:
        """Initial state for every layer on ``device`` (``cuda`` when not
        given; raises where there is none)."""
        dev = resolve_device(device)
        if self.is_all_full:
            # every layer is 'full' and stateless: the placeholders that
            # conv_init and pool_init give a 'full' layer (none for a route,
            # upsample or yolo layer), without their forward of the surface
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            flag = torch.zeros((), dtype=torch.bool, device=dev)
            index = torch.zeros((), dtype=torch.int32, device=dev)
            st, _ = integration_init(self.event_layers[0].spec, dev)
            return (st,) + tuple(
                ConvState(zero, zero.clone()) if ld.kind == "conv"
                else PoolState(index.clone(), flag.clone()) if ld.kind == "pool" else ()
                for ld in self.event_layers[1:])
        states = []
        prev_io = None
        for ld in self.event_layers:
            if ld.kind == "intgr":
                st, prev_io = integration_init(ld.spec, dev)
            elif ld.kind == "conv":
                st, prev_io = conv_init(
                    ld.spec, params[f"w_{ld.name}"], params[f"b_{ld.name}"], prev_io)
            else:  # pool
                st, prev_io = pool_init(ld.spec, prev_io)
            states.append(st)
        return tuple(states)

    # ---- forward --------------------------------------------------------

    def apply_tail(self, params, featuremap_hwc: torch.Tensor) -> torch.Tensor:
        """Dense fc/flatten tail over the last event layer's ``[H, W, C]``
        featuremap, or a batch ``[N, H, W, C]`` of them.  Empty for the
        shipped eFCN."""
        x = featuremap_hwc
        lead = x.shape[:-3]
        for ld in self.dense_tail:
            if ld.kind == "flatten":
                x = x.reshape(*lead, -1)
            else:  # fc: a bf16 featuremap meets float32 weights in float32
                x = leaky(x.float() @ params[f"w_{ld.name}"] + params[f"b_{ld.name}"],
                          self.alpha)
        # network outputs are float32 whatever the activation storage dtype
        return x.float()

    def forward(self, params, state: tuple, chunk: EventChunk, upto: int | None = None
                ) -> tuple[tuple, "OrderedDict[str, LayerIO]"]:
        """One chunk ``[E]`` through every event layer; returns the new
        state and every layer's output.  ``upto`` truncates the chain after
        that many layers: the index is INCLUSIVE over ``event_layers``
        (``upto=0`` runs the integration layer only), unlike
        :meth:`full_frame_forward`'s exclusive one, as in the JAX package.
        A graph (:attr:`is_graph`) is refused: this engine runs a chain."""
        if self.is_graph:
            raise ValueError(
                "the sequential engine runs a chain of layers; a network with route, "
                "upsample, yolo, overlapping-pool or linear layers runs in "
                "scan_parallel (every layer 'full')")
        states = []
        ios: "OrderedDict[str, LayerIO]" = OrderedDict()
        delta_leak = None
        prev_io = None
        for i, (ld, st) in enumerate(zip(self.event_layers, state)):
            if upto is not None and i > upto:
                states.append(st)
                continue
            with span(self._spans[ld.name]):
                if ld.kind == "intgr":
                    st, prev_io, delta_leak = integration_step(ld.spec, st, chunk)
                elif ld.kind == "conv":
                    st, prev_io = conv_step(
                        ld.spec, params[f"w_{ld.name}"], params[f"b_{ld.name}"], st,
                        self._conv_input(ld, prev_io), delta_leak,
                        counts=self.layer_counts[ld.name])
                    st, prev_io = self._layer_output(ld, st, prev_io)
                else:  # pool
                    st, prev_io = pool_step(ld.spec, st, prev_io, delta_leak)
                    st, prev_io = self._layer_output(ld, st, prev_io)
            states.append(st)
            ios[ld.name] = prev_io
        return tuple(states), ios

    def step(self, params, state: tuple, chunk: EventChunk):
        """One chunk -> ``(new_state, output)``: the last event layer's
        featuremap as ``[H, W, C]`` with the dense tail applied."""
        self._steps += 1
        with span("step", self._steps - 1):
            state, ios = self.forward(params, state, chunk)
            last = next(reversed(ios.values()))
            with span("layer.tail"):
                out = self.apply_tail(params, last.featuremap.permute(1, 2, 0))
        return state, out

    def scan(self, params, state: tuple, chunks: EventChunk):
        """Stacked chunks ``[T, E]`` through :meth:`step` one after another;
        returns ``(state, outputs [T, ...])``.  A Python loop (the JAX
        package's ``lax.scan``)."""
        outs = []
        for i in range(chunks.y.shape[0]):
            state, out = self.step(params, state, EventChunk(*(f[i] for f in chunks)))
            outs.append(out)
        return state, torch.stack(outs)

    def full_frame_forward(self, params, state: tuple, frame: torch.Tensor,
                           upto: int | None = None):
        """Forward integrated surfaces through the all-'full' conv/pool
        chain: ``frame`` is one f32 ``[C, H, W]`` surface or a batch
        ``[N, C, H, W]`` (the time-batched leg of :meth:`scan_parallel`,
        where the JAX package vmaps over T).  Returns the YOLO-grid output
        ``[(N,) h, w, c]``, or for a network with ``yolo`` layers a tuple of
        their grids, in order.  ``upto`` truncates after that many layers
        and returns the truncated featuremap (EXCLUSIVE over the
        post-integration layers, as in the JAX package).  The walk follows
        :func:`~async_ev_cnn_torch.layers.conv_stack.plan`: each step runs
        one layer, or a conv and its pool as one op unless ``upto`` cuts
        inside the pair, in the span of its first layer.  A graph's walk
        keeps the outputs that a later route or head reads until it
        returns."""
        with span("scan.conv_stack"):
            steps = conv_stack.plan(self, frame.device, needs_grad(frame, params))
            # surface >= 0, so featuremap == surface: no activation mask
            x, kept, grids = frame, {}, []
            for step in steps:
                if upto is not None and step.start >= upto:
                    return x
                if upto is not None and step.start + len(step.layers) > upto:
                    step = conv_stack.Step("conv", step.start, step.layers[:1])  # cut: unfused
                with span(self._spans[step.layers[0].name]):
                    out = conv_stack.RUNS[step.route](self, params, step, x, kept)
                if step.route == "yolo":
                    grids.append(out)
                else:
                    x = out
                if step.layers[-1].name in self._keep:
                    kept[step.layers[-1].name] = x
            if upto is not None:
                return x
            if self.heads:
                return tuple(grids)
            with span("layer.tail"):
                return self.apply_tail(params, x.movedim(-3, -1))

    def scan_parallel(
        self,
        params,
        state: tuple,
        chunks: EventChunk,
        window: int | None = None,
        ts_window: tuple[int, int] | None = None,
        integrate_engine: str = "auto",
        window_budget_mb: float | None = None,
    ):
        """Parallel-in-time execution of the streaming semantics.

        In 'full' mode the only true recurrence is the leaky surface, so all
        T chunk-boundary surfaces are reconstructed at once
        (:func:`~async_ev_cnn_torch.ops.integrate.integrate_parallel`) and
        the network runs batched over T frames.  ``window`` bounds peak
        memory: the T axis is processed in sequential windows of that many
        chunks (a shorter last window; the JAX package pads it with
        all-invalid chunks, which are exact identity updates).  Or pass
        ``window_budget_mb`` and the window comes from :meth:`auto_window`
        (ignored when ``window`` is given).  ``ts_window`` (``(wh, ww)``)
        is the JAX package's bounding window of the per-chunk ts maps; it
        changes no result, here as there
        (:func:`~async_ev_cnn_torch.ops.integrate.chunk_ts_maps`).
        ``integrate_engine`` selects the surface-reconstruction engine
        ('auto' | 'events' | 'tsmap' | 'maxplus').

        ``chunks`` may carry a leading stream axis (``[S, T, E]`` fields,
        every leaf of ``state`` ``[S, ...]``): the JAX package's
        ``jax.vmap(net.scan_parallel)`` (multi-stream serving), with the
        stream axis written out.  Each window then reconstructs all S*T
        surfaces in one :func:`~async_ev_cnn_torch.ops.integrate.
        integrate_parallel` call (one K1 call on the 'events' engine) and
        runs the conv stack once over the S*T frames, not once a stream;
        the window budget is the whole dispatch's, as under ``vmap``.

        Returns ``(new_state, outputs [T, ...])`` (``[S, T, ...]`` with a
        stream axis, each stream equal to a call of its own); a network with
        ``yolo`` layers gives a tuple of such grids, one a head.
        """
        if not self.is_all_full:
            bad = [
                f"{ld.name}={getattr(ld.spec, 'mode', None)!r}"
                for ld in self.event_layers[1:]
                if getattr(ld.spec, "mode", None) != "full"
            ]
            raise ValueError(
                "scan_parallel requires conv_mode='full' for every conv/pool "
                f"layer; got {', '.join(bad)}"
            )
        leak = self.event_layers[0].spec.leak
        streams = chunks.y.dim() == 3
        tax = int(streams)  # the time axis of the chunks and the outputs
        t = chunks.y.shape[tax]
        if window is None and window_budget_mb is not None:
            window = self.auto_window(t, window_budget_mb)
        if window is None or window >= t:
            window = t
        surf, pts = state[0].surface, state[0].prev_ts
        outs = []
        for a in range(0, t, window):
            cs = EventChunk(*(f.narrow(tax, a, min(window, t - a)) for f in chunks))
            with span("scan.integrate"):
                surfaces, last_ts = integrate_parallel(
                    surf, pts, cs, leak, ts_window=ts_window, engine=integrate_engine)
            # the conv stack runs once over every frame of the window
            frames = surfaces.flatten(0, 1) if streams else surfaces
            out = self.full_frame_forward(params, state, frames)
            if streams:
                lead = surfaces.shape[:2]
                out = (tuple(o.unflatten(0, lead) for o in out) if isinstance(out, tuple)
                       else out.unflatten(0, lead))
            outs.append(out)
            # clone: a view would keep the window's whole surface stack alive
            surf, pts = surfaces.select(tax, -1).clone(), last_ts.select(tax, -1).clone()
        if len(outs) == 1:
            outs = outs[0]
        elif isinstance(outs[0], tuple):  # a graph's grids, each along time
            outs = tuple(torch.cat(parts, dim=tax) for parts in zip(*outs))
        else:
            outs = torch.cat(outs, dim=tax)
        return (IntegrationState(surf, pts),) + tuple(state[1:]), outs


def dense_forward(
    event_layers: list[LayerDef],
    params,
    frame: torch.Tensor,
    variant: str = "tf",
    alpha: float = 0.1,
) -> "OrderedDict[str, torch.Tensor]":
    """Dense frame oracle over the same specs; per-layer activated maps.

    ``variant='tf'``: conv -> leaky -> pool.  ``variant='numpy'`` also
    re-applies the activation after each pool (a reference quirk).  Pooling
    is VALID, matching the event path's output shapes.  ``frame`` is
    ``[H, W]``, ``[C, H, W]`` or a batch ``[N, C, H, W]`` (the trainer's),
    and the maps keep its leading axes.
    """
    outs: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    x = frame[None] if frame.dim() == 2 else frame  # [C, H, W] or [N, C, H, W]
    outs["intgr"] = x
    for ld in event_layers:
        if ld.kind == "intgr":
            continue
        if ld.kind == "conv":
            spec: ConvSpec = ld.spec
            x = conv2d_dense(x, params[f"w_{ld.name}"], params[f"b_{ld.name}"],
                             spec.stride, spec.padding)
            x = leaky(x, spec.alpha)
        else:  # pool
            spec: PoolSpec = ld.spec
            x = maxpool_dense(x, spec.ksize, spec.stride, "VALID")
            if variant == "numpy":
                x = leaky(x, alpha)
        # the event path's activation storage dtype, cast at the same points
        x = x.to(getattr(torch, spec.act_dtype))
        outs[ld.name] = x
    return outs
