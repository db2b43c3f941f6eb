"""Sparse active-site rulebook: gather -> GEMM -> scatter conv updates.

Counterpart of ``async_ev_cnn_tpu/ops/rulebook.py``: the 'sparse' and
'sparse_rows' conv modes extract the active output coordinates into a
fixed-capacity padded rulebook, gather only their receptive fields, run
one product and scatter the results back.  These are plain PyTorch on both
devices, as the JAX package leaves them to XLA; the hand-written kernels
of the 'sparse_pallas' mode are in :mod:`async_ev_cnn_torch.ops.
rulebook_gemm`.

The JAX package's scatters drop out-of-range entries (``mode='drop'``).
Here every invalid entry is sent to a spare row past the end that is cut
off afterwards, so no index is ever out of range and nothing is read back
to the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from async_ev_cnn_torch.ops.conv import conv2d_dense
from async_ev_cnn_torch.ops.masks import mask_to_topk_coords


def patch_indices(ys, xs, stride: int, ksize: tuple[int, int], padded_w: int):
    """Flat spatial indices of each rulebook entry's receptive field:
    ``[K, kh*kw]`` into a ``[Hp * Wp]``-flattened padded plane, entry k's
    patch starting at ``(ys[k]*s, xs[k]*s)``."""
    kh, kw = ksize
    dev = ys.device
    dy = torch.arange(kh, dtype=torch.int32, device=dev).reshape(kh, 1)
    dx = torch.arange(kw, dtype=torch.int32, device=dev).reshape(1, kw)
    offs = (dy * padded_w + dx).reshape(1, kh * kw)
    base = ys.to(torch.int32) * stride * padded_w + xs.to(torch.int32) * stride
    return base[:, None] + offs


def gather_patches(planes: torch.Tensor, sp_idx: torch.Tensor) -> torch.Tensor:
    """Gather patches from ``planes`` ``[N, C, Hp, Wp]`` at ``sp_idx``
    ``[K, kh*kw]`` -> ``[N, K, C * kh * kw]``."""
    n, c, hp, wp = planes.shape
    k, kk = sp_idx.shape
    flat = planes.reshape(n, c, hp * wp)
    patches = flat[:, :, sp_idx.long()]  # [N, C, K, kk]
    return patches.permute(0, 2, 1, 3).reshape(n, k, c * kk)


def rulebook_conv_pair(featuremap, conv_actfn, active, kernel, bias,
                       stride: int, capacity: int):
    """Conv of the (featuremap, conv-actfn) pair at the active sites.

    Args:
      featuremap, conv_actfn: f32 ``[C, Hp, Wp]`` padded planes.
      active: bool ``[oh, ow]``.
      kernel: ``[O, C, kh, kw]``; bias ``[O]`` (added to the featuremap only).

    Returns ``(ys, xs, valid, fm_vals [K, O], cact_vals [K, O], overflow)``,
    ``overflow`` a 0-dim bool tensor, True when the active count exceeded
    ``capacity`` (the caller must then take the dense path).
    """
    o, c, kh, kw = kernel.shape
    ys, xs, valid = mask_to_topk_coords(active, capacity)
    overflow = active.sum() > capacity
    sp_idx = patch_indices(ys, xs, stride, (kh, kw), featuremap.shape[-1])
    patches = torch.stack([
        gather_patches(featuremap[None], sp_idx)[0],
        gather_patches(conv_actfn[None], sp_idx)[0],
    ])                                                           # [2, K, C*kh*kw]
    kmat = kernel.reshape(o, c * kh * kw).t().float()            # [C*kh*kw, O]
    out = torch.einsum("nkd,do->nko", patches.float(), kmat)
    fm_vals = out[0] + bias.float()[None, :]
    return ys, xs, valid, fm_vals, out[1], overflow


def scatter_site_values(dest: torch.Tensor, ys, xs, valid, vals: torch.Tensor):
    """Scatter ``vals [K, O]`` into a copy of ``dest [O, oh, ow]`` at the
    rulebook coordinates; invalid entries are dropped (they go to a spare
    column that is cut off)."""
    o, oh, ow = dest.shape
    idx = torch.where(valid, ys.long() * ow + xs.long(), oh * ow)
    out = torch.cat([dest.reshape(o, oh * ow), dest.new_zeros(o, 1)], dim=1)
    out[:, idx] = vals.t().to(out.dtype)
    return out[:, : oh * ow].reshape(o, oh, ow)


def rows_conv_pair(featuremap, conv_actfn, active, kernel, bias, stride: int,
                   row_capacity: int, pads):
    """Row-granular sparse conv of the (featuremap, conv-actfn) pair.

    Gathers the ``kh`` input rows feeding each active output row from the
    UNPADDED ``[C, H, W]`` planes (row indices clamped into range, rows that
    fall in the padding zeroed, the width halo padded on the small gathered
    block only), then runs one VALID conv with strides ``(1, stride)`` over
    the ``[2R, C, kh, Wp]`` row stack.

    Returns ``(row_idx [R], row_valid [R], fm_rows [R, O, ow],
    ca_rows [R, O, ow], overflow)``.  ``row_idx`` lists the active rows in
    ascending order, then zeros (``jnp.nonzero(..., fill_value=0)``).
    """
    o, c, kh, kw = kernel.shape
    (pt, _), (pl, pr) = pads
    h = featuremap.shape[1]
    dev = featuremap.device
    row_act = active.any(dim=1)  # [oh]
    oh = row_act.shape[0]
    n_rows = row_act.sum()
    overflow = n_rows > row_capacity
    # the active rows in ascending order: top-k of a distinct int32 score
    score = (row_act.to(torch.int32) * (oh + 1)
             - torch.arange(oh, dtype=torch.int32, device=dev))
    first = torch.topk(score, row_capacity).indices
    row_valid = torch.arange(row_capacity, device=dev) < n_rows
    row_idx = torch.where(row_valid, first, 0)

    take = (row_idx[:, None] * stride - pt
            + torch.arange(kh, device=dev)[None, :])     # [R, kh]
    in_range = ((take >= 0) & (take < h)).reshape(-1)
    take_c = take.clamp(0, h - 1).reshape(-1)
    zero = torch.where(in_range, 1.0, 0.0).to(torch.float32)[None, :, None]

    def gather(plane):
        g = plane[:, take_c] * zero                       # [C, R*kh, W]
        g = F.pad(g, (pl, pr))                            # width halo only
        g = g.reshape(c, row_capacity, kh, -1)
        return g.permute(1, 0, 2, 3)                      # [R, C, kh, Wp]

    rows = torch.cat([gather(featuremap), gather(conv_actfn)])  # [2R, C, kh, Wp]
    out = conv2d_dense(rows.float(), kernel, None, (1, stride), "VALID")
    out = out[:, :, 0, :]                                 # [2R, O, ow]
    fm_rows = out[:row_capacity] + bias.float().reshape(1, -1, 1)
    return row_idx, row_valid, fm_rows, out[row_capacity:], overflow


def scatter_row_values(dest: torch.Tensor, row_idx, row_valid, active, vals):
    """Commit row values ``[R, O, ow]`` into a copy of ``dest [O, oh, ow]``:
    within a gathered row only the truly active sites are overwritten.
    Padding entries alias row 0 in the gather; they are written to a spare
    row that is cut off, so they can never clobber a real row-0 update."""
    o, oh, ow = dest.shape
    old = dest[:, row_idx]                                # [O, R, ow]
    sel = active[row_idx] & row_valid[:, None]            # [R, ow]
    new = torch.where(sel[None], vals.permute(1, 0, 2).to(dest.dtype), old)
    idx_w = torch.where(row_valid, row_idx, oh)
    out = torch.cat([dest, dest.new_zeros(o, 1, ow)], dim=1)
    out[:, idx_w] = new
    return out[:, :oh]
