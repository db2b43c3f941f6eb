"""The event-driven YOLO of the port.

Counterpart of ``async_ev_cnn_tpu/models/yolo.py``: :class:`YoloEventTorch`
takes the constructor of ``YoloEventJax`` plus ``device``, with its
functional API (``init_state``/``step``/``scan``) and its closure API
(``build_graph``).  The frame models and checkpoint loading come with later
slices.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from async_ev_cnn_torch.layers.network import EventNetwork
from async_ev_cnn_torch.layers.types import EventChunk
from async_ev_cnn_torch.utils.device import resolve_device
from async_ev_cnn_torch.utils.weights import params_from_jax


class YoloEventTorch:
    """Event-driven YOLO.

    Functional API:
        ``model.set_weights(checkpoint_dict)``        # HWIO, w_/b_ names
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
        device=None,
    ):
        self._device = resolve_device(device)
        self._h_frame = h_frame
        self._w_frame = w_frame
        self._num_classes = num_classes
        self._h_cells = h_cells
        self._w_cells = w_cells
        self._num_bbox = num_bbox
        if ts_window is not None:
            raise NotImplementedError(
                "ts_window (the bounding-window ts maps) waits for a later "
                "slice of the port; the default 'events' engine never reads it")
        if window_budget_mb is not None and window_budget_mb <= 0:
            raise ValueError(
                f"window_budget_mb must be > 0 (got {window_budget_mb}); "
                "pass None for the fixed default window")
        self._window_budget_mb = window_budget_mb
        self.net = EventNetwork(
            cnn_layers, h_frame, w_frame, leak, alpha, cnn_padding,
            conv_mode=conv_mode, capacity_frac=capacity_frac,
            stem_fusion=stem_fusion, activation_dtype=activation_dtype,
        )
        self._params: dict = {}
        if checkpoint is not None:
            raise NotImplementedError(
                "checkpoint loading waits for the port's checkpoint slice; "
                "load the arrays and pass them to set_weights")

    @property
    def grid_shape(self):
        return (self._h_cells, self._w_cells, self._num_classes + self._num_bbox * 5)

    @property
    def device(self):
        return self._device

    def set_weights(self, params) -> None:
        """Install checkpoint-convention weights (``w_<name>`` HWIO kernels,
        ``b_<name>`` biases, as numpy arrays) on this model's device."""
        self._params.update(params_from_jax(params, self._device))

    @property
    def params(self) -> dict:
        """The port's parameter tensors (OIHW kernels) on the device."""
        return self._params

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
        (``scan_parallel``); otherwise the sequential engine, chunk after
        chunk.  Both give the same outputs."""
        if (self.net.is_all_full
                and self._h_frame * self._w_frame <= self.PARALLEL_MAX_PIXELS):
            window = (None if self._window_budget_mb is not None
                      else self.PARALLEL_WINDOW)
            state, outs = self.net.scan_parallel(
                self._params, state, chunks, window=window,
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
