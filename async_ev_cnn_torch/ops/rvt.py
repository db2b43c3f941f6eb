"""The layers of RVT that are not convs: the LayerNorm of the patch
embedding, the MaxViT attention pair and the ConvLSTM's scan.

RVT (Gehrig & Scaramuzza, *Recurrent Vision Transformers for Object
Detection with Event Cameras*, CVPR 2023; github.com/uzh-rpg/RVT) runs four
stages, each an overlapping strided conv and a LayerNorm, one MaxViT pair
(window attention, then grid attention, each half pre-norm with LayerScale
and followed by an MLP) and a ConvLSTM whose state carries from one time
step to the next.  The JAX package has no such network; these are the
port's own, in plain PyTorch over cuBLAS, cuDNN and
``F.scaled_dot_product_attention``.

The maps are channels-last here (``[N, H, W, C]``), as RVT's attention
runs; each LayerNorm is the kernel L1 (``ops/layer_norm.py``), which also
lays the tokens out in the attention's partitions.  The parallel engine
runs a stage layer-major over the ``S x T`` frames of a dispatch (time-major,
so that each time step's frames are adjacent): the pair over every frame
at once (in blocks of :data:`ATTN_BLOCK_TOKENS` tokens,
which bound the transient maps and keep the attention's batch under the
card's grid limit), then the LSTM as a scan over ``T`` with batch ``S``:
its input half ``W_x x`` one GEMM over a block of time steps
(:data:`LSTM_BLOCK_BYTES` of gates), its hidden half ``W_h h`` and the
gate update a step at a time.

Parameters, by layer name ``<n>`` (checkpoint and port alike; the Linear
weights ``[in, out]``, so ``x @ w + b``):

* an embedding: ``w_<n>`` (the conv, OIHW in the port), ``ln_g_<n>`` and
  ``ln_b_<n>``;
* a pair, for each half ``<h>`` of ``win`` and ``grid``: ``n1g_<n>_<h>``
  and ``n1b_`` (the pre-norm; none for a window half that follows an
  embedding, whose output is normed already), ``qkv_w_``, ``qkv_b_``,
  ``proj_w_``, ``proj_b_``, ``ls1_`` (LayerScale), ``n2g_``, ``n2b_``,
  ``fc1_w_``, ``fc1_b_``, ``fc2_w_``, ``fc2_b_`` and ``ls2_``;
* an LSTM: ``w_<n>`` ``[4C, 2C, 1, 1]``, the 1x1 conv over ``cat(x, h)``,
  and ``b_<n>`` ``[4C]``; the first ``3C`` outputs are the forget, input
  and output gates (sigmoid), the last ``C`` the cell input (tanh).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from async_ev_cnn_torch.ops import layer_norm as l1
from async_ev_cnn_torch.ops import lstm_gates
from async_ev_cnn_torch.ops.conv import _apply_tier
from async_ev_cnn_torch.utils.profiling import span

#: LayerNorm's epsilon, RVT's
LN_EPS = 1e-5
#: tokens of the attention pair's block of frames: at most 2**21 rows a
#: GEMM, and at RVT's 60-token partitions 34,952 windows a call, under the
#: 65,535 the attention kernel's grid takes
ATTN_BLOCK_TOKENS = 1 << 21
#: bytes of the LSTM's input gates computed a block of time steps
LSTM_BLOCK_BYTES = 1 << 32
#: the halves of a pair, in order, and the span each runs in
HALVES = (("win", "attn.window"), ("grid", "attn.grid"))


def pair_block_bytes(c: int, h: int, w: int, frames: int) -> int:
    """Peak bytes that :func:`maxvit_pair` allocates beside its map for
    ``frames`` frames of ``[h, w, c]``: 9C floats a token of its largest
    block, while an MLP's GELU runs (the normed tokens, the hidden layer
    and GELU's output); an attention half holds 7C (the partitions, QKV,
    SDPA's output, its copy in token order and the projection)."""
    step = max(1, ATTN_BLOCK_TOKENS // (h * w))
    return 4 * 9 * c * min(frames, step) * h * w


def lstm_block_bytes(c: int, h: int, w: int, frames: int) -> int:
    """Peak bytes of :func:`lstm_scan`'s input gates for ``frames`` time
    steps of one stream's ``[h, w, c]`` maps: a block of
    :data:`LSTM_BLOCK_BYTES`, or every step where fewer fill it."""
    step = 4 * 4 * c * h * w
    return step * min(frames, max(1, LSTM_BLOCK_BYTES // step))


def add_partitions(x: torch.Tensor, p: torch.Tensor, scale: torch.Tensor, ph: int, pw: int,
                   kind: str) -> None:
    """``x += scale * p`` in place, ``p`` the partitions of
    :func:`~async_ev_cnn_torch.ops.layer_norm.partition` ``[B * n, ph * pw,
    C]`` and ``x`` ``[B, H, W, C]``: the
    inverse permutation, through a view of ``x`` in the partitions' order
    (no copy of ``p``)."""
    b, h, w, c = x.shape
    if kind == "win":
        view = x.view(b, h // ph, ph, w // pw, pw, c).permute(0, 1, 3, 2, 4, 5)
    else:
        view = x.view(b, ph, h // ph, pw, w // pw, c).permute(0, 2, 4, 1, 3, 5)
    view.addcmul_(p.view(view.shape), scale)


def attention(x: torch.Tensor, qkv_w, qkv_b, proj_w, proj_b, heads: int) -> torch.Tensor:
    """Multi-head self-attention within each partition ``[B, L, C]``: the
    QKV projection (each head's query, key and value adjacent, RVT's
    layout), ``F.scaled_dot_product_attention`` (scale ``dim_head**-0.5``)
    and the output projection."""
    b, n, c = x.shape
    qkv = torch.addmm(qkv_b, x.reshape(-1, c), qkv_w).view(b, n, heads, -1).transpose(1, 2)
    q, k, v = qkv.chunk(3, dim=-1)
    o = F.scaled_dot_product_attention(q, k, v)
    return torch.addmm(proj_b, o.transpose(1, 2).reshape(-1, c), proj_w).view(b, n, c)


def mlp(x: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """Linear, GELU (erf), Linear over the last axis."""
    c = x.shape[-1]
    hidden = F.gelu(torch.addmm(b1, x.reshape(-1, c), w1))
    return torch.addmm(b2, hidden, w2).view(x.shape)


def maxvit_pair(x: torch.Tensor, params: dict, name: str, spec) -> torch.Tensor:
    """A MaxViT pair over ``x`` ``[N, H, W, C]``, added into ``x`` in place
    (the residuals), in blocks of frames.  Each half: ``x += ls1 *
    attention(norm1(x))`` in the ``attn.window`` or ``attn.grid`` span, then
    ``x += ls2 * mlp(norm2(x))`` in the ``mlp`` span."""
    n, h, w, c = x.shape
    ph, pw = spec.partition
    if x.is_cuda:
        _apply_tier()
    step = max(1, ATTN_BLOCK_TOKENS // (h * w))
    for a in range(0, n, step):
        blk = x[a:a + step]
        for half, label in HALVES:
            p = lambda key: params.get(f"{key}_{name}_{half}")  # noqa: E731
            with span(label):
                # the pre-norm and the partition in one pass (L1); the
                # window half after an embedding only partitions
                skip = half == "win" and spec.skip_first_norm
                y = l1.layer_norm(blk, None if skip else p("n1g"), p("n1b"), LN_EPS, half,
                                  ph, pw)
                y = attention(y, p("qkv_w"), p("qkv_b"), p("proj_w"), p("proj_b"), spec.heads)
                add_partitions(blk, y, p("ls1"), ph, pw, half)
            with span("mlp"):
                y = mlp(l1.layer_norm(blk, p("n2g"), p("n2b"), LN_EPS), p("fc1_w"),
                        p("fc1_b"), p("fc2_w"), p("fc2_b"))
                blk.addcmul_(y, p("ls2"))
    return x


def lstm_scan(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor):
    """The ConvLSTM over ``x`` ``[T, R, C]`` (T time steps, time-major; R
    rows, the S streams' P pixels; channels last) from the state ``h``,
    ``c`` ``[R, C]``.  ``weight`` ``[4C, 2C, 1, 1]`` is the published 1x1
    conv over ``cat(x, h)``: its input half runs as one GEMM over a block of
    time steps (``lstm.input``), its hidden half and the gate update a step
    at a time (``lstm.scan``): ``c = f * c + i * tanh(g)``, ``h = o *
    tanh(c)``, the gate update the kernel G1 (``ops/lstm_gates.py``).  Each
    step's maps are whole matrices of R rows: one GEMM into the step's input
    gates, one G1.  Returns the hidden maps of every step ``[T, R, C]`` and
    the last ``h``, ``c``."""
    t, r, ch = x.shape
    if x.is_cuda:
        _apply_tier()
    wx = weight[:, :ch, 0, 0].t().contiguous()
    wh = weight[:, ch:, 0, 0].t().contiguous()
    out = torch.empty_like(x)
    # G1 updates the cell in place, row-major: a one-stream state's rows
    # are a transposed view of its channels-first map
    c = c.clone(memory_format=torch.contiguous_format)
    step = max(1, LSTM_BLOCK_BYTES // (r * 4 * ch * 4))
    for a in range(0, t, step):
        tb = min(step, t - a)
        with span("lstm.input"):
            gx = torch.addmm(bias, x[a:a + tb].reshape(-1, ch), wx).view(tb, r, 4 * ch)
        with span("lstm.scan"):
            for k in range(tb):
                h = lstm_gates.lstm_gates(gx[k].addmm_(h, wh), c, out[a + k])
    # a copy: a view would keep every step's hidden maps alive with the state
    return out, h.clone(), c
