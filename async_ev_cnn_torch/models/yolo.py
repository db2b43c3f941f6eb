"""The three network variants of the port.

Counterpart of ``async_ev_cnn_tpu/models/yolo.py``:

* :class:`YoloEventTorch` — the async event-driven network (``YoloEventJax``),
  with its functional API (``init_state``/``step``/``scan``) and its
  closure API (``build_graph``);
* :class:`YoloFrameTorch` — the dense frame network (``YoloFrameJax``, the
  reference's ``frame_tf`` baseline), fed with an integrated frame;
* :class:`YoloFrameNumpy` — the dense pure-numpy oracle, copied from the
  JAX package.

All three share the reference models' constructor (h_frame, w_frame,
num_classes, cnn_layers, cnn_padding, h_cells, w_cells, num_bbox, alpha,
leak, checkpoint); the torch models also take ``device`` (``cuda`` when not
given).  Weights follow the checkpoint contract ``w_<name>`` /
``b_<name>`` with HWIO kernels, from ``set_weights`` or from a checkpoint
(``checkpoint=``, :meth:`_YoloBase.restore`: .npz or TF bundle).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from async_ev_cnn_torch.layers.network import EventNetwork, dense_forward
from async_ev_cnn_torch.layers.types import EventChunk
from async_ev_cnn_torch.ops.conv import tf_same_pads
from async_ev_cnn_torch.utils.checkpoint import load_params, normalize_names
from async_ev_cnn_torch.utils.device import resolve_device
from async_ev_cnn_torch.utils.weights import fold_batchnorm, params_from_jax


class _YoloBase:
    """The shared constructor and weight handling.  Weights live in
    ``params`` in the form :meth:`_convert` gives them: numpy arrays in the
    checkpoint convention here, device tensors in the port's layout in the
    torch models."""

    def __init__(
        self,
        h_frame: int,
        w_frame: int,
        num_classes: int,
        cnn_layers: "OrderedDict[str, list[int]]",
        cnn_padding: str,
        h_cells: int,
        w_cells: int,
        num_bbox: int,
        alpha: float,
        leak: float,
        checkpoint: str | None = None,
        conv_mode: str = "dense",
        capacity_frac: float = 0.25,
        ts_window: int | None = None,
        stem_fusion: bool | str = "auto",
        window_budget_mb: float | None = None,
        activation_dtype: str = "float32",
    ):
        self._h_frame = h_frame
        self._w_frame = w_frame
        self._num_classes = num_classes
        self._cnn_layers = cnn_layers
        self._padding = cnn_padding
        self._h_cells = h_cells
        self._w_cells = w_cells
        self._num_bbox = num_bbox
        self._alpha = alpha
        self._leak = leak
        self._conv_mode = conv_mode
        self._capacity_frac = capacity_frac
        self._stem_fusion = stem_fusion
        self._activation_dtype = activation_dtype
        if ts_window is not None and ts_window < 1:
            raise ValueError(
                f"ts_window must be >= 1 (got {ts_window}); pass None to "
                "disable the windowed ts-map path")
        self._ts_window = (ts_window, ts_window) if ts_window is not None else None
        if window_budget_mb is not None and window_budget_mb <= 0:
            raise ValueError(
                f"window_budget_mb must be > 0 (got {window_budget_mb}); "
                "pass None for the fixed default window")
        self._window_budget_mb = window_budget_mb
        self._params: dict = {}
        if checkpoint is not None:
            self.restore(checkpoint)

    @property
    def grid_shape(self):
        return (self._h_cells, self._w_cells, self._num_classes + self._num_bbox * 5)

    def _convert(self, params) -> dict:
        return {k: np.asarray(v) for k, v in params.items()}

    def restore(self, checkpoint_path: str, restrict_vars=None) -> None:
        """Load every tensor of a checkpoint (.npz, TF bundle, or a
        directory of them: ``utils/checkpoint.load_params``) into the
        weights, object-graph names normalized to flat ones; with
        ``restrict_vars``, only the names it holds."""
        params = normalize_names(load_params(checkpoint_path))
        if restrict_vars is not None:
            params = {k: v for k, v in params.items() if k in restrict_vars}
        self.set_weights(params)

    def set_weights(self, params) -> None:
        """Install checkpoint-convention weights (``w_<name>`` HWIO kernels,
        ``b_<name>`` biases, as numpy arrays)."""
        self._params.update(self._convert(params))

    @property
    def params(self) -> dict:
        return self._params


class _TorchYolo(_YoloBase):
    """A :class:`_YoloBase` whose weights are the port's tensors (OIHW
    kernels) on ``device`` (``cuda`` when not given; raises where there is
    none)."""

    def __init__(self, *args, device=None, **kwargs):
        self._device = resolve_device(device)
        super().__init__(*args, **kwargs)

    def _convert(self, params) -> dict:
        # a checkpoint in darknet's form (batch-norm statistics beside a
        # conv's kernel) is folded into kernels and biases at load
        return fold_batchnorm(params_from_jax(params, self._device))

    @property
    def device(self):
        return self._device


class YoloEventTorch(_TorchYolo):
    """Event-driven YOLO.

    Functional API:
        ``model.set_weights(checkpoint_dict)``        # or checkpoint=path
        ``state = model.init_state()``
        ``state, grid = model.step(state, chunk)``    # one chunk [E]
        ``state, grids = model.scan(state, chunks)``  # [T, h, w, C + B*5]

    Closure API (the reference's): ``graph = model.build_graph(None);
    out = graph(events, reset)`` with ``events`` a host ``[N, 3]`` (or
    ``[N, 4]`` with polarity) array of (y, x, ts) rows.
    """

    # frames per time-batched window: bounds activation memory for long
    # inputs (the scan_parallel window pads nothing; see EventNetwork)
    PARALLEL_WINDOW = 256
    # above this frame size the per-frame activations cap the time window
    # and the JAX package's sequential scan measured faster on the TPU; the
    # port routes the same way until an H100 measurement says otherwise
    PARALLEL_MAX_PIXELS = 300_000

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.net = EventNetwork(
            self._cnn_layers, self._h_frame, self._w_frame, self._leak,
            self._alpha, self._padding, conv_mode=self._conv_mode,
            capacity_frac=self._capacity_frac, stem_fusion=self._stem_fusion,
            activation_dtype=self._activation_dtype,
        )

    def init_state(self):
        return self.net.init_state(self._params, self._device)

    def step(self, state, chunk: EventChunk):
        """One chunk ``[E]`` through the sequential engine; returns
        ``(state, grid [h_cells, w_cells, C + B*5])``."""
        state, out = self.net.step(self._params, state, chunk)
        return state, out.reshape(self.grid_shape)

    def scan(self, state, chunks: EventChunk):
        """Stacked micro-batches ``[T, E]`` in one call; returns
        ``(state, grids [T, h_cells, w_cells, C + B*5])``.  When every
        conv/pool layer runs in 'full' mode and the frame holds at most
        ``PARALLEL_MAX_PIXELS`` pixels this is the parallel-in-time path
        (``scan_parallel``, given ``ts_window`` as a square window);
        otherwise the sequential engine, chunk after chunk.  Both give the
        same outputs."""
        if (self.net.is_all_full
                and self._h_frame * self._w_frame <= self.PARALLEL_MAX_PIXELS):
            window = (None if self._window_budget_mb is not None
                      else self.PARALLEL_WINDOW)
            state, outs = self.net.scan_parallel(
                self._params, state, chunks, window=window,
                ts_window=self._ts_window,
                window_budget_mb=self._window_budget_mb)
        else:
            state, outs = self.net.scan(self._params, state, chunks)
        return state, outs.reshape(outs.shape[0], *self.grid_shape)

    def build_graph(self, _=None):
        """The reference's closure API: ``graph(events, reset)`` feeds one
        host ``[N, 3|4]`` batch of (y, x, ts[, p]) rows through :meth:`step`
        and returns the grid as a numpy array; ``reset`` (or the first
        call) starts from :meth:`init_state`.  Chunks are padded to a
        power-of-two capacity of at least 16, as in the JAX package."""
        state = {"value": None}

        def graph(events, reset: bool):
            events = np.asarray(events)
            n = events.shape[0]
            if reset or state["value"] is None:
                state["value"] = self.init_state()
            cap = max(16, 1 << (n - 1).bit_length())
            chunk = EventChunk.from_arrays(
                events[:, 0], events[:, 1], events[:, 2],
                p=events[:, 3] if events.shape[1] > 3 else None,
                capacity=cap, device=self._device,
            )
            state["value"], out = self.step(state["value"], chunk)
            return out.cpu().numpy()

        return graph


class YoloFrameTorch(_TorchYolo):
    """Dense frame YOLO (the ``YoloFrameJax`` analog): the conv -> leaky ->
    maxpool chain of :func:`~async_ev_cnn_torch.layers.network.dense_forward`
    plus the dense tail, fed with an integrated frame ``[H, W]`` or
    ``[C, H, W]`` (``ops/integrate.integrate_frame``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # the event network's specs, for the same dense topology
        self.net = EventNetwork(
            self._cnn_layers, self._h_frame, self._w_frame, self._leak,
            self._alpha, self._padding,
        )

    def forward(self, frame) -> torch.Tensor:
        """One frame -> the grid ``[h_cells, w_cells, C + B*5]`` on the
        model's device."""
        frame = torch.as_tensor(frame, dtype=torch.float32, device=self._device)
        outs = dense_forward(self.net.event_layers, self._params, frame, "tf")
        last = next(reversed(outs.values()))
        out = self.net.apply_tail(self._params, last.permute(1, 2, 0))
        return out.reshape(self.grid_shape)

    def build_graph(self, _=None):
        def graph(frame):
            return self.forward(frame).cpu().numpy()

        return graph


class YoloFrameNumpy(_YoloBase):
    """Dense pure-numpy oracle (the ``YoloFrameNumpy`` analog), copied from
    the JAX package: ``sliding_window_view`` + einsum convolutions.  It
    keeps the reference's quirk of re-applying the activation after each
    pool (frame_numpy.py:76-78), which scales negative pooled values by
    alpha twice."""

    def _conv(self, x, name):
        k = self._params[f"w_{name}"]  # HWIO
        b = self._params[f"b_{name}"]
        kh, kw, _, _ = k.shape
        if self._padding == "SAME":
            (pt, pb), (pl, pr) = tf_same_pads(x.shape[1], x.shape[2], kh, kw, 1)
            x = np.pad(x, ((0, 0), (pt, pb), (pl, pr)))
        win = np.lib.stride_tricks.sliding_window_view(x, (kh, kw), axis=(1, 2))
        # win: [C, oh, ow, kh, kw]; kernel HWIO -> einsum over C, kh, kw
        out = np.einsum("cyxhw,hwco->oyx", win, k, optimize=True) + b[:, None, None]
        return out.astype(np.float32)

    @staticmethod
    def _pool(x, ksize, stride):
        c, h, w = x.shape
        kh, kw = ksize
        oh, ow = (h - kh) // stride + 1, (w - kw) // stride + 1
        win = np.lib.stride_tricks.sliding_window_view(x, (kh, kw), axis=(1, 2))
        win = win[:, ::stride, ::stride][:, :oh, :ow]
        return win.max(axis=(-1, -2))

    def _leaky(self, x):
        return np.maximum(x, x * self._alpha)

    def forward(self, frame):
        """One frame (an array, or a tensor on any device, read on the
        host) -> the grid ``[h_cells, w_cells, C + B*5]`` as an array."""
        if isinstance(frame, torch.Tensor):
            frame = frame.cpu().numpy()
        x = np.asarray(frame, np.float32)
        x = x[None] if x.ndim == 2 else x
        flat_tail = False
        for name, size in self._cnn_layers.items():
            if "conv" in name:
                x = self._leaky(self._conv(x, name))
            elif "pool" in name:
                x = self._leaky(self._pool(x, size, size[0]))
            elif "flatten" in name:
                x = self._leaky(x.transpose(1, 2, 0).reshape(-1))
                flat_tail = True
            elif "fc" in name:
                x = self._leaky(x @ self._params[f"w_{name}"] + self._params[f"b_{name}"])
                flat_tail = True
        if not flat_tail:
            x = x.transpose(1, 2, 0)
        return x.reshape(self.grid_shape)

    def build_graph(self, _=None):
        return self.forward
