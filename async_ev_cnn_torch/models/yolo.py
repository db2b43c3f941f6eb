"""The event-driven YOLO of the port.

Counterpart of ``async_ev_cnn_tpu/models/yolo.py``: :class:`YoloEventTorch`
takes the constructor of ``YoloEventJax`` plus ``device``.  This slice runs
its parallel-in-time path (every conv/pool layer in 'full' mode); the
frame models, ``build_graph``, ``step`` and the sequential ``scan`` come
with later slices, as does checkpoint loading.
"""

from __future__ import annotations

from collections import OrderedDict

from async_ev_cnn_torch.layers.network import EventNetwork
from async_ev_cnn_torch.layers.types import EventChunk
from async_ev_cnn_torch.utils.device import resolve_device
from async_ev_cnn_torch.utils.weights import params_from_jax


class YoloEventTorch:
    """Event-driven YOLO over the parallel-in-time path.

        ``model.set_weights(checkpoint_dict)``        # HWIO, w_/b_ names
        ``state = model.init_state()``
        ``state, grids = model.scan(state, chunks)``  # [T, h, w, C + B*5]
    """

    # frames per time-batched window: bounds activation memory for long
    # inputs (the scan_parallel window pads nothing; see EventNetwork)
    PARALLEL_WINDOW = 256
    # above this frame size the JAX package takes its sequential scan,
    # which this slice does not carry
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

    def scan(self, state, chunks: EventChunk):
        """Stacked micro-batches ``[T, E]`` in one call; returns
        ``(state, grids [T, h_cells, w_cells, C + B*5])``."""
        if not self.net.is_all_full:
            raise NotImplementedError(
                "scan with incremental conv modes waits for the port's "
                "incremental-mode slice; use conv_mode='full' or 'auto'")
        if self._h_frame * self._w_frame > self.PARALLEL_MAX_PIXELS:
            raise NotImplementedError(
                f"frames above {self.PARALLEL_MAX_PIXELS} pixels take the "
                "sequential scan, which waits for a later slice of the port")
        window = None if self._window_budget_mb is not None else self.PARALLEL_WINDOW
        state, outs = self.net.scan_parallel(
            self._params, state, chunks, window=window,
            window_budget_mb=self._window_budget_mb)
        return state, outs.reshape(outs.shape[0], *self.grid_shape)
