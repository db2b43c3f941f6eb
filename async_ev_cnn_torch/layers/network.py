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
"""

from __future__ import annotations

import copy
from collections import Counter, OrderedDict
from math import prod
from typing import Any, NamedTuple

import torch

from async_ev_cnn_torch.layers.conv2d import ConvSpec, conv_init, conv_step
from async_ev_cnn_torch.layers.integration import (
    IntegrationSpec,
    integration_init,
    integration_step,
)
from async_ev_cnn_torch.layers.maxpool import PoolSpec, pool_init, pool_step
from async_ev_cnn_torch.layers.types import EventChunk, IntegrationState, LayerIO
from async_ev_cnn_torch.ops import stem
from async_ev_cnn_torch.ops.conv import conv2d_dense, leaky, matmul_precision
from async_ev_cnn_torch.ops.integrate import integrate_parallel
from async_ev_cnn_torch.ops.pool import maxpool_dense
from async_ev_cnn_torch.utils.device import resolve_device


class LayerDef(NamedTuple):
    kind: str  # 'intgr' | 'conv' | 'pool' | 'fc' | 'flatten'
    name: str
    spec: Any


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
    """Returns ``(event_layers, dense_tail)``, as the JAX package does."""
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
    for name, size in layer_defs.items():
        if "conv" in name:
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
            spec = ConvSpec(
                in_shape=prev_shape,
                out_channels=cout,
                ksize=(kh, kw),
                stride=1,
                alpha=alpha,
                padding=padding,
                mode=mode,
                capacity_frac=capacity_frac,
                window_frac=window_frac,
                act_dtype=activation_dtype if mode == "full" else "float32",
            )
            event_layers.append(LayerDef("conv", name, spec))
            prev_shape = spec.out_shape
        elif "pool" in name:
            spec = PoolSpec(
                in_shape=prev_shape, ksize=tuple(size), stride=size[0],
                mode="full" if force_full else "event",
                act_dtype=activation_dtype if force_full else "float32",
            )
            event_layers.append(LayerDef("pool", name, spec))
            prev_shape = spec.out_shape
        elif "fc" in name:
            tail.append(LayerDef("fc", name, tuple(size)))
        elif "flatten" in name:
            tail.append(LayerDef("flatten", name, None))
        else:
            raise ValueError(f"unknown layer kind in name {name!r}")
    return event_layers, tail


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
        # conv+pool pairs the parallel path MAY run as one space-to-depth
        # conv: indices into event_layers[1:] of the conv whose following
        # pool could fold in; whether they fuse is _fusion_active's call
        self._s2d_pairs = frozenset(
            i
            for i, (c, p) in enumerate(zip(self.event_layers[1:], self.event_layers[2:]))
            if c.kind == "conv" and p.kind == "pool"
            and stem.s2d_pair_applicable(c.spec, p.spec) and stem.s2d_pair_wins(c.spec)
        )
        #: per conv layer of the sequential engine: host reads of device
        #: flags (``host_syncs``), ``dense_fallbacks`` and
        #: ``kernel_launches`` since the last :meth:`reset_counts`
        self.layer_counts: dict[str, Counter] = {
            ld.name: Counter() for ld in self.event_layers if ld.kind == "conv"}

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
        front half (the same model as the JAX package)."""
        ispec = self.event_layers[0].spec
        surface_px = ispec.channels * ispec.h * ispec.w
        shapes = [surface_px] + [
            int(prod(ld.spec.out_shape)) for ld in self.event_layers[1:]
        ]
        peak_pair = max(a + b for a, b in zip(shapes[:-1], shapes[1:]))
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
        :meth:`full_frame_forward`'s exclusive one, as in the JAX package."""
        states = []
        ios: "OrderedDict[str, LayerIO]" = OrderedDict()
        delta_leak = None
        prev_io = None
        for i, (ld, st) in enumerate(zip(self.event_layers, state)):
            if upto is not None and i > upto:
                states.append(st)
                continue
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
        state, ios = self.forward(params, state, chunk)
        last = next(reversed(ios.values()))
        return state, self.apply_tail(params, last.featuremap.permute(1, 2, 0))

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
        ``[(N,) h, w, c]``.  ``upto`` truncates after that many conv/pool
        layers and returns the truncated featuremap (EXCLUSIVE over the
        post-integration layers, as in the JAX package).  A fused stem pair
        (:meth:`_fusion_active`) runs as one space-to-depth conv, unless
        ``upto`` cuts inside it."""
        # surface >= 0, so featuremap == surface: no activation mask
        io = LayerIO(surface=frame, layer_actfn=None, conv_actfn=None, mask=None)
        layers, states = self.event_layers[1:], state[1:]
        fuse = bool(self._s2d_pairs) and self._fusion_active()
        i = 0
        while i < len(layers):
            if upto is not None and i >= upto:
                return io.featuremap
            ld, st = layers[i], states[i]
            if fuse and i in self._s2d_pairs and (upto is None or upto >= i + 2):
                fm = stem.fused_conv_pool(self._conv_input(ld, io).featuremap,
                                          params[f"w_{ld.name}"],
                                          params[f"b_{ld.name}"], ld.spec.alpha)
                # one cast at the pair's pooled output: the float32 conv
                # output is never stored
                act = getattr(torch, layers[i + 1].spec.act_dtype)
                io = LayerIO(surface=fm.to(act), layer_actfn=None, conv_actfn=None,
                             mask=None)
                i += 2
                continue
            if ld.kind == "conv":
                _, io = conv_step(ld.spec, params[f"w_{ld.name}"],
                                  params[f"b_{ld.name}"], st, self._conv_input(ld, io), 0.0)
            else:
                _, io = pool_step(ld.spec, st, io, 0.0)
            i += 1
        if upto is not None:
            return io.featuremap
        return self.apply_tail(params, io.featuremap.movedim(-3, -1))

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
        stream axis, each stream equal to a call of its own).
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
            surfaces, last_ts = integrate_parallel(
                surf, pts, cs, leak, ts_window=ts_window, engine=integrate_engine)
            # the conv stack runs once over every frame of the window
            frames = surfaces.flatten(0, 1) if streams else surfaces
            out = self.full_frame_forward(params, state, frames)
            outs.append(out.unflatten(0, surfaces.shape[:2]) if streams else out)
            # clone: a view would keep the window's whole surface stack alive
            surf, pts = surfaces.select(tax, -1).clone(), last_ts.select(tax, -1).clone()
        outs = outs[0] if len(outs) == 1 else torch.cat(outs, dim=tax)
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
