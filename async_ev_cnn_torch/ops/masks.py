"""Active-site mask algebra.

Counterpart of ``async_ev_cnn_tpu/ops/masks.py``: the set of output sites
whose receptive field touches an input event is a binary dilation of the
event mask by the kernel footprint (a max-pool over the padded mask), and
the rulebook coordinates of the sparse conv modes are a top-k over an
integer score, so every shape stays fixed and nothing here reads a value
back to the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dilate_mask(
    mask: torch.Tensor,
    ksize: tuple[int, int],
    stride: int,
    pads: tuple[tuple[int, int], tuple[int, int]] = ((0, 0), (0, 0)),
) -> torch.Tensor:
    """Output active mask: sites whose receptive field touches an input site.

    Args:
      mask: bool ``[H, W]`` input active sites.
      ksize: ``(k_h, k_w)`` kernel footprint.
      stride: conv/pool stride.
      pads: explicit ((top, bottom), (left, right)) pads, the conv's own, so
        the mask lives in output coordinates.

    Returns:
      bool ``[out_h, out_w]`` dilated active mask.
    """
    (pt, pb), (pl, pr) = pads
    x = F.pad(mask.float()[None, None], (pl, pr, pt, pb))
    return F.max_pool2d(x, tuple(ksize), stride)[0, 0] > 0


def pool_out_shape(in_h: int, in_w: int, ksize: tuple[int, int], stride: int):
    """VALID pooling output shape."""
    return (in_h - ksize[0]) // stride + 1, (in_w - ksize[1]) // stride + 1


def window_view(x: torch.Tensor, ksize: tuple[int, int], stride: int) -> torch.Tensor:
    """Non-overlapping window view ``[C, H, W] -> [C, oh, ow, kh*kw]``.

    Requires ``stride == ksize`` (non-overlapping pooling, the only
    configuration of the reference's event path): crop, reshape, permute.
    """
    k_h, k_w = ksize
    if stride != k_h or stride != k_w:
        raise NotImplementedError(
            "window_view requires stride == ksize (non-overlapping pooling); "
            f"got ksize={ksize} stride={stride}"
        )
    c, h, w = x.shape
    oh, ow = pool_out_shape(h, w, ksize, stride)
    x = x[:, : oh * k_h, : ow * k_w]
    x = x.reshape(c, oh, k_h, ow, k_w)
    return x.permute(0, 1, 3, 2, 4).reshape(c, oh, ow, k_h * k_w)


def chunk_to_mask(y, x, valid, h: int, w: int) -> torch.Tensor:
    """Scatter padded event coordinates into a bool ``[H, W]`` mask.

    Invalid and out-of-range entries are dropped: they land in a spare
    slot past the ``H*W`` sites that is cut off afterwards (the JAX
    package's ``mode='drop'`` scatter).
    """
    ok = valid & (y >= 0) & (y < h) & (x >= 0) & (x < w)
    idx = torch.where(ok, y.long() * w + x.long(), h * w)
    mask = torch.zeros(h * w + 1, dtype=torch.bool, device=y.device)
    mask[idx] = True
    return mask[: h * w].reshape(h, w)


def mask_bounding_box(mask: torch.Tensor):
    """Bounding box of the True sites of ``mask`` ``[H, W]``.

    Returns ``(y0, x0, y1, x1, any_active)`` as 0-dim tensors with
    inclusive extents; when nothing is active the box is (0, 0, 0, 0).
    """
    h, w = mask.shape
    rows = mask.any(dim=1)
    cols = mask.any(dim=0)
    ridx = torch.arange(h, dtype=torch.int32, device=mask.device)
    cidx = torch.arange(w, dtype=torch.int32, device=mask.device)
    big = torch.tensor(1 << 30, dtype=torch.int32, device=mask.device)
    neg = torch.tensor(-1, dtype=torch.int32, device=mask.device)
    zero = torch.zeros((), dtype=torch.int32, device=mask.device)
    any_active = rows.any()

    def pick(v):
        return torch.where(any_active, v, zero)

    return (
        pick(torch.where(rows, ridx, big).amin()),
        pick(torch.where(cols, cidx, big).amin()),
        pick(torch.where(rows, ridx, neg).amax()),
        pick(torch.where(cols, cidx, neg).amax()),
        any_active,
    )


def mask_to_block_coords(mask: torch.Tensor, capacity: int, block_w: int = 8):
    """Extract up to ``capacity`` active 1 x ``block_w`` site blocks.

    Blocks are x-aligned strips; a block is active when any of its sites
    is.  Returns ``(by, bx, valid)`` each ``[capacity]`` (``bx`` in block
    units) and the 0-dim total count of active blocks, for the overflow
    check.
    """
    h, w = mask.shape
    wb = -(-w // block_w)
    padded = F.pad(mask, (0, wb * block_w - w))
    blocks = padded.reshape(h, wb, block_w).any(dim=-1)
    capacity = min(capacity, blocks.numel())  # tiny deep layers
    by, bx, valid = mask_to_topk_coords(blocks, capacity)
    return by, bx, valid, blocks.sum()


def mask_to_topk_coords(mask: torch.Tensor, capacity: int):
    """Extract up to ``capacity`` active coordinates from a mask (rulebook).

    Returns ``(ys, xs, valid)`` each ``[capacity]``, int32/int32/bool.  The
    order is the JAX package's: the active sites row-major, then the
    inactive ones row-major with ``valid`` False.  The int32 score
    ``flat * (n + 1) - index`` is distinct per site, so ``torch.topk``
    orders it exactly as ``lax.top_k`` does.
    """
    h, w = mask.shape
    flat = mask.reshape(-1)
    n = h * w
    capacity = min(capacity, n)
    score = (flat.to(torch.int32) * (n + 1)
             - torch.arange(n, dtype=torch.int32, device=mask.device))
    idx = torch.topk(score, capacity).indices
    valid = flat[idx]
    return (idx // w).to(torch.int32), (idx % w).to(torch.int32), valid
