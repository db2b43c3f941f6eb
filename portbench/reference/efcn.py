"""Plain reference of the eFCN (Cannici et al., CVPR-W 2019, arXiv:1805.07931).

Straightforward PyTorch of the published semantics, independent of the
program under test (it imports nothing of it, nor of the JAX package):

* the leaky surface, chunk after chunk: every pixel decays by the
  chunk's leak ``leak * (last_ts - prev_ts)``, clamped at zero, then each
  pixel that has events in the chunk gains ``1 - leak * (last_ts - ts)``
  of its latest event, clamped at zero.  Every product that feeds the
  surface is rounded to the ``2**-20`` grid, as the system's numerical
  contract states;
* the dense network on a surface: each conv (SAME padding, stride 1)
  followed by the leaky ReLU ``max(x, alpha * x)``, each pool a ``k x k``
  stride-``k`` max; the output grid ``[h_cells, w_cells, C + B*5]``;
* the YOLO head's decoding of a grid into boxes and class probabilities.

The incremental engine computes the same function as the dense network on
the current surface (the paper's asynchronous == dense equivalence), so
one reference serves both engines.  Convolutions run in IEEE float32 with
TF32 off in cuDNN and cuBLAS, unless ``use_tf32`` (the control).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

SNAP = 2.0**20


def snap(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x * SNAP) / SNAP


@contextlib.contextmanager
def tf32(enabled: bool):
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class SurfaceChain:
    """Leaky surfaces of ``streams`` independent streams, ``[S, H*W]``.

    :meth:`run` takes a block of chunks of every stream.  What one chunk
    contributes (its leak, and each pixel's gain from its latest event)
    depends only on timestamps, so it is worked out for the whole block at
    once; the surface itself then steps chunk after chunk.  The latest
    event of a pixel has the largest gain (the gain falls as the event
    ages), so a pixel's gain is the maximum over its events.  ``dtype`` is
    the surface's storage and arithmetic type (float32; bfloat16 for the
    control)."""

    def __init__(self, streams: int, h: int, w: int, leak: float, device,
                 dtype=torch.float32):
        self.h, self.w = h, w
        self.dtype = dtype
        self.leak = torch.tensor(leak, dtype=torch.float32)
        self.surface = torch.zeros((streams, h * w), dtype=dtype, device=device)
        self.prev_ts = torch.zeros(streams, dtype=torch.int64, device=device)

    def run(self, y, x, ts, valid, keep=()) -> torch.Tensor:
        """Chunks ``[S, T, E]`` of each stream, in order; returns the
        surfaces after the chunks listed in ``keep``, ``[S, len(keep), H, W]``."""
        s_n, t_n, _ = ts.shape
        hw = self.h * self.w
        ts = ts.long()
        # the running last-event timestamp: an empty chunk keeps the previous
        chunk_max = torch.where(valid, ts, -1).amax(dim=-1)
        last = torch.cummax(torch.maximum(chunk_max, self.prev_ts[:, None]), dim=1).values
        before = torch.cat([self.prev_ts[:, None], last[:, :-1]], dim=1)
        decay = snap((last - before).float() * self.leak).to(self.dtype)
        gain = 1 - snap((last[..., None] - ts).float() * self.leak)
        plane = (torch.arange(s_n, device=ts.device)[:, None, None] * t_n
                 + torch.arange(t_n, device=ts.device)[None, :, None])
        flat = torch.where(valid, plane * hw + y.long() * self.w + x.long(), 0)
        gains = torch.full((s_n * t_n * hw,), float("-inf"), device=ts.device)
        gains.scatter_reduce_(0, flat.reshape(-1),
                              torch.where(valid, gain, float("-inf")).reshape(-1), "amax")
        gains = torch.where(gains == float("-inf"), 0, gains).to(self.dtype)
        gains = gains.view(s_n, t_n, hw)
        slot = {t: i for i, t in enumerate(keep)}
        out = torch.empty((s_n, len(slot), hw), dtype=self.dtype, device=ts.device)
        s = self.surface.clone()
        for t in range(t_n):
            s.sub_(decay[:, t, None]).clamp_(min=0)
            s.add_(gains[:, t]).clamp_(min=0)
            if t in slot:
                out[:, slot[t]] = s
        self.surface = s
        self.prev_ts = last[:, -1].clone()
        return out.view(s_n, len(slot), self.h, self.w)


def dense_grid(surfaces: torch.Tensor, weights: dict, layers: dict, alpha: float,
               use_tf32: bool = False) -> torch.Tensor:
    """``[N, 1, H, W]`` float32 surfaces -> ``[N, h_cells, w_cells, C + B*5]``."""
    x = surfaces.float()
    with tf32(use_tf32):
        for name, size in layers.items():
            if "conv" in name:
                kh, kw = size[0], size[1]
                pt, pl = (kh - 1) // 2, (kw - 1) // 2
                x = F.pad(x, (pl, kw - 1 - pl, pt, kh - 1 - pt))
                x = F.conv2d(x, weights[f"w_{name}"], weights[f"b_{name}"])
                x = torch.maximum(x, x * alpha)
            elif "pool" in name:
                x = F.max_pool2d(x, tuple(size), stride=tuple(size))
            else:
                raise ValueError(f"the reference has no layer like {name!r}")
    return x.permute(0, 2, 3, 1)


def decode(grid: torch.Tensor, num_classes: int, num_bbox: int, frame_h: int,
           frame_w: int):
    """YOLO grids ``[..., hc, wc, C + B*5]`` -> ``(boxes [..., N, 4]`` as
    pixel centre x, centre y, width, height, ``probs [..., N, C])`` with
    ``N = hc * wc * B``: cell offsets, square-root-coded sizes, class
    scores times the box confidence."""
    hc, wc = grid.shape[-3], grid.shape[-2]
    lead = grid.shape[:-3]
    box = grid[..., num_classes:].reshape(*lead, hc, wc, num_bbox, 5)
    col = torch.arange(wc, device=grid.device, dtype=torch.float32)[:, None]
    row = torch.arange(hc, device=grid.device, dtype=torch.float32)[:, None, None]
    boxes = torch.stack([(box[..., 0] + col) / wc * frame_w,
                         (box[..., 1] + row) / hc * frame_h,
                         box[..., 2] ** 2 * frame_w,
                         box[..., 3] ** 2 * frame_h], dim=-1).reshape(*lead, -1, 4)
    probs = grid[..., None, :num_classes] * box[..., 4:5]
    return boxes, probs.reshape(*lead, -1, num_classes)
