"""Incremental 2-D convolution layer.

Counterpart of ``async_ev_cnn_tpu/layers/conv2d.py`` (its docstring has the
reference semantics).  Per step, with ``active`` the output sites whose
receptive field touches an input event:

  1. ``before_sign = fm >= 0``
  2. ``fm -= snap(conv_actfn * delta_leak)``       (leak propagation)
  3. ``fm[active]  = conv(prev.featuremap) + b``   at the active sites
  4. ``cact[active] = conv(prev.conv_actfn)``      (no bias)
  5. out events = sites where any channel's sign changed, plus active sites.

Modes ('full' recomputes every site and keeps no state):

* ``'dense'``: the full conv of the pair, committed at the active sites;
* ``'sparse'``: a capacity-bounded rulebook gather -> product -> scatter
  (:mod:`async_ev_cnn_torch.ops.rulebook`);
* ``'sparse_pallas'``: the same update through the hand-written CUDA
  kernels of :mod:`async_ev_cnn_torch.ops.rulebook_gemm` — K3 over 1x8 site
  blocks at stride 1, K4 over single sites otherwise (the name is the JAX
  package's, so configurations read the same);
* ``'sparse_rows'``: whole active output rows, one batched conv;
* ``'window'``: the conv inside a fixed window around the active box.

Each sparse or window mode falls back to 'dense' when its capacity
overflows or the box does not fit.  The JAX package selects between both
branches on the device (``lax.cond``); here the flag is read back to the
host before the branch runs, so the kernel is launched only when its sites
fit: one device-to-host read per such layer and step.  ``conv_step`` adds
those reads (``host_syncs``), the fallbacks (``dense_fallbacks``) and the
kernel launches (``kernel_launches``) to an optional per-layer counter.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from async_ev_cnn_torch.layers.conv_stack import full_conv
from async_ev_cnn_torch.layers.types import ConvState, LayerIO
from async_ev_cnn_torch.ops import rulebook_gemm
from async_ev_cnn_torch.ops.conv import (
    conv2d_dense,
    conv_out_shape,
    conv_pads,
    leaky_mask,
)
from async_ev_cnn_torch.ops.masks import (
    dilate_mask,
    mask_bounding_box,
    mask_to_block_coords,
    mask_to_topk_coords,
)
from async_ev_cnn_torch.ops.numerics import snap
from async_ev_cnn_torch.ops.rulebook import (
    rows_conv_pair,
    rulebook_conv_pair,
    scatter_row_values,
    scatter_site_values,
)
from async_ev_cnn_torch.utils.profiling import span

BLOCK_W = rulebook_gemm.BLOCK_W


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
    def block_capacity(self) -> int:
        """Static 1x8 site-block capacity of 'sparse_pallas' at stride 1."""
        return max(8, -(-self.capacity // BLOCK_W))

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


def _count(counts, key: str, n: int = 1) -> None:
    if counts is not None:
        counts[key] += n


def _read_flag(flag: torch.Tensor, counts) -> bool:
    """Bring a device flag to the host: one device-to-host read."""
    _count(counts, "host_syncs")
    with span("host.sync"):
        return bool(flag)


def _conv_pair(spec: ConvSpec, kernel, bias, featuremap, conv_actfn):
    """One batched conv over [featuremap; conv_actfn]; bias on the first
    plane only."""
    out = conv2d_dense(torch.stack([featuremap, conv_actfn]).float(), kernel, None,
                       spec.stride, spec.padding)
    return out[0] + bias.float().reshape(-1, 1, 1), out[1]


def _dense_update(spec, kernel, bias, state, prev_io, active, fm_leaked):
    with span("conv.dense"):
        conv_fm, conv_cact = _conv_pair(spec, kernel, bias, prev_io.featuremap,
                                        prev_io.conv_actfn)
        return (torch.where(active, conv_fm, fm_leaked),
                torch.where(active, conv_cact, state.conv_actfn))


def _make_io(spec: ConvSpec, state: ConvState, mask) -> LayerIO:
    actfn = leaky_mask(state.featuremap, spec.alpha)
    # the conv_actfn accessor is the product with this layer's mask
    return LayerIO(surface=state.featuremap, layer_actfn=actfn,
                   conv_actfn=state.conv_actfn * actfn, mask=mask)


def conv_init(spec: ConvSpec, kernel, bias, prev_init_io: LayerIO
              ) -> tuple[ConvState, LayerIO]:
    """Initial state: the dense conv of the predecessor's initial
    featuremap; conv-actfn starts at zero.  'full' mode is stateless: 0-dim
    placeholders keep the state structure uniform."""
    if spec.mode == "full":
        zero = torch.zeros((), dtype=torch.float32, device=kernel.device)
        fm = full_conv(spec, kernel, bias, prev_init_io.featuremap)
        return ConvState(featuremap=zero, conv_actfn=zero.clone()), LayerIO(fm, None, None, None)
    fm = conv2d_dense(prev_init_io.featuremap, kernel, bias, spec.stride, spec.padding)
    state = ConvState(featuremap=fm, conv_actfn=torch.zeros_like(fm))
    _, oh, ow = spec.out_shape
    return state, _make_io(spec, state, torch.zeros((oh, ow), dtype=torch.bool,
                                                    device=fm.device))


def _padded(spec: ConvSpec, plane: torch.Tensor) -> torch.Tensor:
    """``[C, H, W]`` -> the conv's zero-padded ``[C, Hp, Wp]``."""
    (pt, pb), (pl, pr) = spec.pads
    return F.pad(plane.float(), (pl, pr, pt, pb))


def _hwc_padded(spec: ConvSpec, plane: torch.Tensor) -> torch.Tensor:
    """The padded plane in the kernels' HWC layout ``[Hp, Wp, C]``."""
    return _padded(spec, plane).permute(1, 2, 0).contiguous()


def _kernel_sites(spec, active, counts):
    """'sparse_pallas': the active 1x8 site blocks at stride 1 (K3's), the
    active sites otherwise (K4's), as ``(ys, xs, valid)``; None when they
    overflow the capacity."""
    if spec.stride == 1:
        ys, xs, valid, n_blocks = mask_to_block_coords(active, spec.block_capacity,
                                                       BLOCK_W)
        overflow = n_blocks > spec.block_capacity
    else:
        ys, xs, valid = mask_to_topk_coords(active, spec.capacity)
        overflow = active.sum() > spec.capacity
    return None if _read_flag(overflow, counts) else (ys, xs, valid)


def _kernel_update(spec, kernel, bias, state, prev_io, active, fm_leaked, counts, sites):
    """'sparse_pallas': K3 over the active 1x8 site blocks at stride 1, K4
    over the active sites otherwise (``sites``, :func:`_kernel_sites`)."""
    ys, xs, valid = sites
    gemm = (rulebook_gemm.rulebook_gather_gemm_blocks if spec.stride == 1
            else rulebook_gemm.rulebook_gather_gemm)
    before = rulebook_gemm.LAUNCHES[gemm.__name__]
    fm_vals, ca_vals = gemm(
        _hwc_padded(spec, prev_io.featuremap), _hwc_padded(spec, prev_io.conv_actfn),
        kernel.permute(2, 3, 1, 0).contiguous().float(),  # OIHW -> HWIO
        bias.float().contiguous(), ys, xs, stride=spec.stride)
    _count(counts, "kernel_launches", rulebook_gemm.LAUNCHES[gemm.__name__] - before)
    if spec.stride == 1:
        # expand blocks to sites; commit only truly active in-range sites
        ow = spec.out_shape[2]
        offs = torch.arange(BLOCK_W, dtype=torch.int32, device=active.device)
        sy = ys.repeat_interleave(BLOCK_W)
        sx = (xs[:, None] * BLOCK_W + offs[None, :]).reshape(-1)
        site_active = (sx < ow) & active[sy.long(), sx.clamp(max=ow - 1).long()]
        ys, xs, valid = sy, sx, valid.repeat_interleave(BLOCK_W) & site_active
    o = fm_vals.shape[-1]
    return (scatter_site_values(fm_leaked, ys, xs, valid, fm_vals.reshape(-1, o)),
            scatter_site_values(state.conv_actfn, ys, xs, valid, ca_vals.reshape(-1, o)))


def _sparse_update(spec, kernel, bias, state, prev_io, active, fm_leaked, counts,
                   sites=None):
    """Rulebook update of the active sites, or the dense-masked update when
    the rulebook's capacity overflows (equivalence is never sacrificed);
    'sparse_pallas' takes its ``sites`` from :func:`_kernel_sites`."""
    if spec.mode == "sparse_rows":
        # rows mode gathers clamped row indices from the UNPADDED planes
        row_idx, row_valid, fm_rows, ca_rows, overflow = rows_conv_pair(
            prev_io.featuremap, prev_io.conv_actfn, active, kernel, bias,
            spec.stride, spec.row_capacity, spec.pads,
        )
        if not _read_flag(overflow, counts):
            return (scatter_row_values(fm_leaked, row_idx, row_valid, active, fm_rows),
                    scatter_row_values(state.conv_actfn, row_idx, row_valid, active,
                                       ca_rows))
    elif spec.mode == "sparse_pallas":
        if sites is not None:
            with span("conv.k3"):
                return _kernel_update(spec, kernel, bias, state, prev_io, active,
                                      fm_leaked, counts, sites)
    else:
        ys, xs, valid, fm_vals, ca_vals, overflow = rulebook_conv_pair(
            _padded(spec, prev_io.featuremap), _padded(spec, prev_io.conv_actfn),
            active, kernel, bias, spec.stride, spec.capacity,
        )
        if not _read_flag(overflow, counts):
            return (scatter_site_values(fm_leaked, ys, xs, valid, fm_vals),
                    scatter_site_values(state.conv_actfn, ys, xs, valid, ca_vals))
    _count(counts, "dense_fallbacks")
    return _dense_update(spec, kernel, bias, state, prev_io, active, fm_leaked)


def _window_update(spec, kernel, bias, state, prev_io, active, fm_leaked, counts):
    """The conv only inside a fixed-size window around the active bounding
    box, or the dense-masked update when the box does not fit.  The box
    comes to the host in one read: it sets the slice offsets."""
    if spec.stride != 1:
        raise NotImplementedError("window mode requires stride 1")
    wh, ww = spec.window
    o, oh, ow = spec.out_shape
    kh, kw = spec.ksize
    y0, x0, y1, x1, _ = mask_bounding_box(active)
    _count(counts, "host_syncs")
    with span("host.sync"):
        y0, x0, y1, x1 = torch.stack([y0, x0, y1, x1]).tolist()
    if not (y1 - y0 < wh and x1 - x0 < ww):
        _count(counts, "dense_fallbacks")
        return _dense_update(spec, kernel, bias, state, prev_io, active, fm_leaked)
    oy = min(max(y0, 0), oh - wh)
    ox = min(max(x0, 0), ow - ww)

    def window(plane):
        return _padded(spec, plane)[:, oy:oy + wh + kh - 1, ox:ox + ww + kw - 1]

    out = conv2d_dense(torch.stack([window(prev_io.featuremap),
                                    window(prev_io.conv_actfn)]), kernel, None, 1,
                       "VALID")
    conv_fm_w = out[0] + bias.float().reshape(-1, 1, 1)
    act_w = active[oy:oy + wh, ox:ox + ww]
    fm = fm_leaked.clone()
    cact = state.conv_actfn.clone()
    fm[:, oy:oy + wh, ox:ox + ww] = torch.where(
        act_w, conv_fm_w, fm_leaked[:, oy:oy + wh, ox:ox + ww])
    cact[:, oy:oy + wh, ox:ox + ww] = torch.where(
        act_w, out[1], state.conv_actfn[:, oy:oy + wh, ox:ox + ww])
    return fm, cact


def conv_step(spec: ConvSpec, kernel, bias, state: ConvState, prev_io: LayerIO,
              delta_leak, counts=None) -> tuple[ConvState, LayerIO]:
    """One step of the layer.

    ``kernel`` is OIHW, ``delta_leak`` the f32 0-dim leak of the
    integration layer (unused in 'full' mode).  ``counts``, a
    ``collections.Counter`` or ``None``, receives this step's host reads,
    dense fallbacks and kernel launches.
    """
    if spec.mode == "full":
        # the activated map: layer_actfn None (the JAX package's scalar 1)
        return state, LayerIO(full_conv(spec, kernel, bias, prev_io.featuremap), None, None, None)

    before_sign = state.featuremap >= 0
    # snapped, so every copy of this expression agrees on the updated sign
    fm_leaked = state.featuremap - snap(state.conv_actfn * delta_leak)
    with span("conv.sites"):
        active = dilate_mask(prev_io.mask, spec.ksize, spec.stride, spec.pads)
        sites = (_kernel_sites(spec, active, counts) if spec.mode == "sparse_pallas"
                 else None)

    if spec.mode == "window":
        fm, cact = _window_update(spec, kernel, bias, state, prev_io, active,
                                  fm_leaked, counts)
    elif spec.mode in ("sparse", "sparse_pallas", "sparse_rows"):
        fm, cact = _sparse_update(spec, kernel, bias, state, prev_io, active,
                                  fm_leaked, counts, sites)
    elif spec.mode == "dense":
        fm, cact = _dense_update(spec, kernel, bias, state, prev_io, active, fm_leaked)
    else:
        raise ValueError(f"unknown conv mode {spec.mode!r}")

    changed = (before_sign != (fm >= 0)).any(dim=0)
    new_state = ConvState(featuremap=fm, conv_actfn=cact)
    return new_state, _make_io(spec, new_state, changed | active)
