"""Leaky-surface input layer.

Counterpart of ``async_ev_cnn_tpu/layers/integration.py``: a static spec
plus the initial state.  The per-chunk step of the sequential engine comes
with the incremental modes; the parallel-in-time path integrates with
:func:`async_ev_cnn_torch.ops.integrate.integrate_parallel`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from async_ev_cnn_torch.layers.types import IntegrationState, LayerIO


class IntegrationSpec(NamedTuple):
    leak: float
    h: int
    w: int
    channels: int = 1  # 1 = polarity dropped (reference); 2 = ON/OFF channels

    @property
    def out_shape(self) -> tuple[int, int, int]:
        return (self.channels, self.h, self.w)


def _make_io(surface: torch.Tensor, mask: torch.Tensor) -> LayerIO:
    # layer_actfn == conv_actfn == (surface > 0)
    actfn = (surface > 0).float()
    return LayerIO(surface=surface, layer_actfn=actfn, conv_actfn=actfn, mask=mask)


def integration_init(spec: IntegrationSpec, device) -> tuple[IntegrationState, LayerIO]:
    """Zero surface at timestamp 0 on ``device``."""
    surface = torch.zeros(spec.out_shape, dtype=torch.float32, device=device)
    state = IntegrationState(
        surface=surface,
        prev_ts=torch.zeros((), dtype=torch.int32, device=device))
    return state, _make_io(
        surface, torch.zeros((spec.h, spec.w), dtype=torch.bool, device=device))
