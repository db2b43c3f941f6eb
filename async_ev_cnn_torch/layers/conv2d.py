"""2-D convolution layer.

Counterpart of ``async_ev_cnn_tpu/layers/conv2d.py``.  :class:`ConvSpec`
carries every field of the JAX spec, so configurations read the same; this
slice runs the 'full' (recompute every site) mode, which is what the
parallel-in-time path runs.  The incremental modes ('dense', 'sparse',
'sparse_pallas', 'sparse_rows', 'window') raise ``NotImplementedError``
until their slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from async_ev_cnn_torch.layers.types import ConvState, LayerIO
from async_ev_cnn_torch.ops.conv import conv2d_dense, conv_out_shape, conv_pads, leaky


class ConvSpec(NamedTuple):
    in_shape: tuple[int, int, int]  # (C, H, W) of the previous layer
    out_channels: int
    ksize: tuple[int, int]
    stride: int
    alpha: float
    padding: str  # 'SAME' | 'VALID'
    # 'dense' | 'sparse' | 'sparse_pallas' | 'sparse_rows' | 'window' | 'full'
    mode: str = "dense"
    capacity_frac: float = 0.25  # sparse rulebook capacity as out-site fraction
    window_frac: float = 0.25  # window-mode extent as a fraction of each axis
    act_dtype: str = "float32"  # 'full'-mode activation storage dtype

    @property
    def capacity(self) -> int:
        _, oh, ow = self.out_shape
        cap = max(8, int(oh * ow * self.capacity_frac))
        return min(cap, oh * ow)

    @property
    def row_capacity(self) -> int:
        """Static active-row capacity for 'sparse_rows' mode."""
        _, oh, _ = self.out_shape
        return min(oh, max(8, int(oh * self.capacity_frac)))

    @property
    def window(self) -> tuple[int, int]:
        """Static window extent (out coords) for 'window' mode, multiple of 8."""
        _, oh, ow = self.out_shape
        wh = min(oh, max(8, (int(oh * self.window_frac) + 7) // 8 * 8))
        ww = min(ow, max(8, (int(ow * self.window_frac) + 7) // 8 * 8))
        return wh, ww

    @property
    def pads(self):
        _, h, w = self.in_shape
        return conv_pads(h, w, *self.ksize, self.stride, self.padding)

    @property
    def out_shape(self) -> tuple[int, int, int]:
        _, h, w = self.in_shape
        oh, ow = conv_out_shape(h, w, *self.ksize, self.stride, self.padding)
        return (self.out_channels, oh, ow)


def _require_full(spec: ConvSpec) -> None:
    if spec.mode != "full":
        raise NotImplementedError(
            f"conv mode {spec.mode!r} waits for the port's incremental-mode "
            "slice; this slice runs mode 'full' (conv_mode='full' or 'auto')")


def _full_io(spec: ConvSpec, kernel, bias, prev_io: LayerIO) -> LayerIO:
    """Full-recompute output: one conv of the predecessor's featuremap with
    the activation folded in, so ``surface`` is the activated map and
    ``layer_actfn`` is ``None`` (the scalar 1 of the JAX package)."""
    fm = leaky(conv2d_dense(prev_io.featuremap, kernel, bias, spec.stride,
                            spec.padding), spec.alpha)
    return LayerIO(surface=fm, layer_actfn=None, conv_actfn=None, mask=None)


def conv_init(spec: ConvSpec, kernel, bias, prev_init_io: LayerIO
              ) -> tuple[ConvState, LayerIO]:
    """Initial state.  'full' mode is stateless: 0-dim placeholders keep
    the state structure uniform."""
    _require_full(spec)
    zero = torch.zeros((), dtype=torch.float32, device=kernel.device)
    return ConvState(featuremap=zero, conv_actfn=zero.clone()), _full_io(
        spec, kernel, bias, prev_init_io)


def conv_step(spec: ConvSpec, kernel, bias, state: ConvState, prev_io: LayerIO,
              delta_leak) -> tuple[ConvState, LayerIO]:
    """One step; in 'full' mode a recompute of every site."""
    _require_full(spec)
    return state, _full_io(spec, kernel, bias, prev_io)
