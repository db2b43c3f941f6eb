"""Plain reference of RVT (Gehrig & Scaramuzza, "Recurrent Vision
Transformers for Object Detection with Event Cameras", CVPR 2023,
arXiv:2212.05598; github.com/uzh-rpg/RVT) with its YOLOX PAFPN and head.

Straightforward PyTorch of the published network, float32 with TF32 off
in cuDNN and cuBLAS (unless ``use_tf32``, the control of the benchmark).
It runs time-major: :func:`step` takes one frame of each stream and the
streams' states and returns the heads' outputs and the new states.  It
imports nothing of the port nor of the JAX package, and shares no code
with them:

* a stage: ``ConvDownsampling_Cf2Cl`` (a ``(2f - 1)``-wide conv at stride
  ``f``, padded ``f - 1``, no bias, then ``LayerNorm``), one
  ``MaxVitAttentionPairCl`` (``PartitionAttentionCl`` over windows, then
  over the grid: ``x + ls1 * attn(norm1(x))``, ``x + ls2 * mlp(norm2(x))``,
  the first block's window half without ``norm1``; ``SelfAttentionCl``
  with each head's query, key and value adjacent in the QKV projection,
  softmax of ``q k^T * dim_head**-0.5``; the MLP ``Linear``, GELU (erf),
  ``Linear``), and ``DWSConvLSTM2d`` without its depthwise conv: a 1x1
  conv over ``cat(x, h)``, whose first ``3C`` channels are the sigmoid
  forget, input and output gates and last ``C`` the tanh cell input,
  ``c = f * c + i * g``, ``h = o * tanh(c)``;
* ``YOLOPAFPN`` over the stage 2-4 states (``lateral_conv0``, ``C3_p4``,
  ``reduce_conv1``, ``C3_p3``, ``bu_conv2``, ``C3_n3``, ``bu_conv1``,
  ``C3_n4``; ``CSPLayer`` with ``round(3 * depth)`` bottlenecks and no
  shortcut), nearest upsampling by 2;
* ``YOLOXHead``: per level a 1x1 stem, two 3x3 convs to the class logits
  and two to the box regression and objectness; every ``BaseConv`` a conv
  without bias, PyTorch's ``BatchNorm2d`` ``(x - mean) / sqrt(var + eps) *
  gamma + beta`` and SiLU; :func:`decode` is YOLOX's decode.

Parameter names are those of the port's configuration
(``configs/rvt_base_event.yml``: ``embed<k>``, ``attn<k>``, ``lstm<k>``,
the PAFPN's and head's layers), listed by :func:`param_shapes`.

Departures from the published network, each forced by the event camera or
by the comparison:

* the input is one channel, the leaky event surface (as in the eFCN of
  Cannici et al. 2019), in place of RVT's 20-channel event histogram (10
  time bins x 2 polarities over 50 ms); the stem conv's width is the
  published one;
* the recurrent step is one chunk-boundary surface (a chunk of events),
  where RVT steps every 50 ms;
* no relative position bias in the attention (RVT-B's configuration uses
  none either; listed because MaxViT's has one);
* 3 classes (car, pedestrian, two-wheeler: the 1 Mpx dataset's);
* the weights are the caller's (seeded), not trained ones;
* the decode gives every cell's box (no threshold, no NMS).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

#: LayerNorm's and BatchNorm's epsilons (PyTorch's defaults, RVT's)
LN_EPS = 1e-5
BN_EPS = 1e-5
#: the range the seeded LayerScale gammas are drawn from
LAYER_SCALE = (0.1, 0.3)


def architecture(input_channels: int = 1, embed_dim: int = 64, stage_dims=(64, 128, 256, 512),
                 dim_head: int = 32, partition=(6, 10), mlp_ratio: int = 4,
                 fpn_depth: float = 0.67, classes: int = 3) -> dict:
    """RVT-B's published widths (the defaults), or a small copy for tests."""
    in_ch = tuple(stage_dims[1:])  # the PAFPN reads stages 2-4
    return {"input_channels": input_channels, "embed_dim": embed_dim,
            "stage_dims": tuple(stage_dims), "dim_head": dim_head,
            "partition": tuple(partition), "mlp_ratio": mlp_ratio,
            "bottlenecks": round(3 * fpn_depth), "fpn_channels": in_ch,
            "head_width": int(256 * in_ch[-1] / 1024), "classes": classes,
            "strides": (8, 16, 32)}


def _convs(arch) -> dict:
    """Every conv of the PAFPN and the head: name -> (cin, cout, k, stride,
    batch-normed)."""
    c0, c1, c2 = arch["fpn_channels"]
    n, hid, out = arch["bottlenecks"], arch["head_width"], {}

    def base(name, cin, cout, k=1, stride=1):
        out[name] = (cin, cout, k, stride, True)

    def csp(name, cin, cout):
        h = cout // 2
        base(f"{name}_c1", cin, h)
        base(f"{name}_c2", cin, h)
        for i in range(n):
            base(f"{name}_m{i}a", h, h)
            base(f"{name}_m{i}b", h, h, 3)
        base(f"{name}_c3", 2 * h, cout)

    base("conv_lat0", c2, c1)
    csp("csp_p4", 2 * c1, c1)
    base("conv_red1", c1, c0)
    csp("csp_p3", 2 * c0, c0)
    base("conv_bu2", c0, c0, 3, 2)
    csp("csp_n3", 2 * c0, c1)
    base("conv_bu1", c1, c1, 3, 2)
    csp("csp_n4", 2 * c1, c2)
    for s, cin in zip(arch["strides"], (c0, c1, c2)):
        base(f"conv_h{s}_stem", cin, hid)
        for part in ("c", "r"):
            base(f"conv_h{s}_{part}1", hid, hid, 3)
            base(f"conv_h{s}_{part}2", hid, hid, 3)
        out[f"conv_h{s}_cls"] = (hid, arch["classes"], 1, 1, False)
        out[f"conv_h{s}_reg"] = (hid, 4, 1, 1, False)
        out[f"conv_h{s}_obj"] = (hid, 1, 1, 1, False)
    return out


def param_shapes(arch) -> dict:
    """Every parameter's name and shape, in a fixed order (batch norm
    unfolded: ``gamma_``, ``beta_``, ``mean_``, ``var_``; its running
    statistics are buffers, not parameters: :func:`parameter_count` leaves
    them out)."""
    shapes = {}
    cin = arch["input_channels"]
    for k, dim in enumerate(arch["stage_dims"], 1):
        ks = 7 if k == 1 else 3
        shapes[f"w_embed{k}"] = (dim, cin, ks, ks)
        shapes[f"ln_g_embed{k}"] = shapes[f"ln_b_embed{k}"] = (dim,)
        for half in ("win", "grid"):
            t = f"attn{k}_{half}"
            if half == "grid":
                shapes[f"n1g_{t}"] = shapes[f"n1b_{t}"] = (dim,)
            shapes[f"qkv_w_{t}"], shapes[f"qkv_b_{t}"] = (dim, 3 * dim), (3 * dim,)
            shapes[f"proj_w_{t}"], shapes[f"proj_b_{t}"] = (dim, dim), (dim,)
            shapes[f"ls1_{t}"] = shapes[f"n2g_{t}"] = shapes[f"n2b_{t}"] = (dim,)
            hid = arch["mlp_ratio"] * dim
            shapes[f"fc1_w_{t}"], shapes[f"fc1_b_{t}"] = (dim, hid), (hid,)
            shapes[f"fc2_w_{t}"], shapes[f"fc2_b_{t}"] = (hid, dim), (dim,)
            shapes[f"ls2_{t}"] = (dim,)
        shapes[f"w_lstm{k}"], shapes[f"b_lstm{k}"] = (4 * dim, 2 * dim, 1, 1), (4 * dim,)
        cin = dim
    for name, (ci, co, k, _, bn) in _convs(arch).items():
        shapes[f"w_{name}"] = (co, ci, k, k)
        for stat in (("gamma", "beta", "mean", "var") if bn else ("b",)):
            shapes[f"{stat}_{name}"] = (co,)
    return shapes


def parameter_count(arch) -> int:
    """The published model's parameters (batch norm's running statistics
    are buffers)."""
    n = 0
    for name, shape in param_shapes(arch).items():
        if not name.startswith(("mean_", "var_")):
            size = 1
            for d in shape:
                size *= d
            n += size
    return n


def make_weights(arch, seed: int, device) -> dict:
    """Seeded weights, made on ``device`` from one generator in
    :func:`param_shapes`' order (the same seed and device give the same
    weights): conv kernels He-normal ``N(0, 2 / fan_in)``, the heads' class,
    box and objectness kernels too (their logits stay within about 2 at
    384x640, so the sigmoids do not saturate); Linear weights and the
    LSTM's conv ``N(0, 1 / fan_in)``; LayerNorm and batch-norm scales and
    the batch-norm variances uniform in [0.5, 1.5), their shifts and means
    and every bias ``N(0, 0.1^2)``; LayerScale uniform in
    :data:`LAYER_SCALE` (a trained model's scale, not the training's
    1e-5, at which a wrong attention would hide in any tolerance)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**64)
    out = {}
    for name, shape in param_shapes(arch).items():
        kind, n = name.split("_", 1)[0], shape[0]
        if len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            gain = 1.0 if "lstm" in name else 2.0
            v = torch.randn(shape, generator=gen, device=device) * (gain / fan_in) ** 0.5
        elif len(shape) == 2:
            v = torch.randn(shape, generator=gen, device=device) * (1.0 / shape[0]) ** 0.5
        elif kind in ("ls1", "ls2"):
            lo, hi = LAYER_SCALE
            v = torch.rand(n, generator=gen, device=device) * (hi - lo) + lo
        elif kind in ("gamma", "var") or name.startswith(("ln_g", "n1g", "n2g")):
            v = torch.rand(n, generator=gen, device=device) + 0.5
        else:
            v = torch.randn(n, generator=gen, device=device) * 0.1
        out[name] = v
    return out


@contextlib.contextmanager
def _precision(use_tf32: bool):
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = use_tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def window_partition(x, ws):
    b, h, w, c = x.shape
    x = x.view(b, h // ws[0], ws[0], w // ws[1], ws[1], c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws[0], ws[1], c)


def window_reverse(windows, ws, hw):
    h, w = hw
    c = windows.shape[-1]
    x = windows.view(-1, h // ws[0], w // ws[1], ws[0], ws[1], c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, h, w, c)


def grid_partition(x, gs):
    b, h, w, c = x.shape
    x = x.view(b, gs[0], h // gs[0], gs[1], w // gs[1], c)
    return x.permute(0, 2, 4, 1, 3, 5).contiguous().view(-1, gs[0], gs[1], c)


def grid_reverse(windows, gs, hw):
    h, w = hw
    c = windows.shape[-1]
    x = windows.view(-1, h // gs[0], w // gs[1], gs[0], gs[1], c)
    return x.permute(0, 3, 1, 4, 2, 5).contiguous().view(-1, h, w, c)


def self_attention(x, wt, t, heads):
    """``SelfAttentionCl`` over partitions ``[B, ph, pw, C]``."""
    shape = x.shape
    b, c = shape[0], shape[-1]
    dh = c // heads
    qkv = (x @ wt[f"qkv_w_{t}"] + wt[f"qkv_b_{t}"]).view(b, -1, heads, 3 * dh).transpose(1, 2)
    q, k, v = qkv.chunk(3, dim=3)
    attn = ((q @ k.transpose(-2, -1)) * dh ** -0.5).softmax(dim=-1)
    y = (attn @ v).transpose(1, 2).reshape(*shape[:-1], c)
    return y @ wt[f"proj_w_{t}"] + wt[f"proj_b_{t}"]


def partition_attention(x, wt, t, arch, window: bool, skip_first_norm: bool):
    """``PartitionAttentionCl`` over ``[B, H, W, C]``."""
    c = x.shape[-1]
    ps = arch["partition"]
    y = x if skip_first_norm else F.layer_norm(x, (c,), wt[f"n1g_{t}"], wt[f"n1b_{t}"], LN_EPS)
    hw = x.shape[1:3]
    if window:
        y = window_reverse(self_attention(window_partition(y, ps), wt, t, c // arch["dim_head"]),
                           ps, hw)
    else:
        y = grid_reverse(self_attention(grid_partition(y, ps), wt, t, c // arch["dim_head"]),
                         ps, hw)
    x = x + wt[f"ls1_{t}"] * y
    y = F.layer_norm(x, (c,), wt[f"n2g_{t}"], wt[f"n2b_{t}"], LN_EPS)
    y = F.gelu(y @ wt[f"fc1_w_{t}"] + wt[f"fc1_b_{t}"]) @ wt[f"fc2_w_{t}"] + wt[f"fc2_b_{t}"]
    return x + wt[f"ls2_{t}"] * y


def stage(x, wt, k, arch, hc):
    """One RVT stage over ``[S, C, H, W]`` frames from the LSTM state
    ``hc`` (None: zeros); returns its output and new state."""
    factor = 4 if k == 1 else 2
    x = F.conv2d(x, wt[f"w_embed{k}"], None, stride=factor, padding=factor - 1)
    x = x.permute(0, 2, 3, 1)
    x = F.layer_norm(x, (x.shape[-1],), wt[f"ln_g_embed{k}"], wt[f"ln_b_embed{k}"], LN_EPS)
    x = partition_attention(x, wt, f"attn{k}_win", arch, True, True)
    x = partition_attention(x, wt, f"attn{k}_grid", arch, False, False)
    x = x.permute(0, 3, 1, 2)
    h, c = hc if hc is not None else (torch.zeros_like(x), torch.zeros_like(x))
    mix = F.conv2d(torch.cat((x, h), dim=1), wt[f"w_lstm{k}"], wt[f"b_lstm{k}"])
    gates, cell_input = torch.tensor_split(mix, [3 * x.shape[1]], dim=1)
    f, i, o = torch.tensor_split(torch.sigmoid(gates), 3, dim=1)
    c = f * c + i * torch.tanh(cell_input)
    h = o * torch.tanh(c)
    return h, (h, c)


def base_conv(x, wt, name, spec):
    cin, cout, k, stride, bn = spec
    x = F.conv2d(x, wt[f"w_{name}"], None if bn else wt[f"b_{name}"], stride=stride,
                 padding=(k - 1) // 2)
    if not bn:
        return x
    x = ((x - wt[f"mean_{name}"][:, None, None]) / torch.sqrt(wt[f"var_{name}"][:, None, None]
                                                            + BN_EPS)
         * wt[f"gamma_{name}"][:, None, None] + wt[f"beta_{name}"][:, None, None])
    return F.silu(x)


def csp_layer(x, wt, name, convs, n):
    x1 = base_conv(x, wt, f"{name}_c1", convs[f"{name}_c1"])
    x2 = base_conv(x, wt, f"{name}_c2", convs[f"{name}_c2"])
    for i in range(n):
        x1 = base_conv(base_conv(x1, wt, f"{name}_m{i}a", convs[f"{name}_m{i}a"]), wt,
                       f"{name}_m{i}b", convs[f"{name}_m{i}b"])
    return base_conv(torch.cat((x1, x2), dim=1), wt, f"{name}_c3", convs[f"{name}_c3"])


def step(weights, arch, frames, state=None, use_tf32: bool = False):
    """One time step: ``frames`` ``[S, C, H, W]`` (one frame a stream) and
    ``state`` (each stage's ``(h, c)``, None at a stream's start) ->
    ``(levels, state)``, the heads' raw outputs ``[S, gh, gw, 4 + 1 +
    classes]`` (box, objectness and class logits) at strides 8, 16, 32."""
    wt, convs, n = weights, _convs(arch), arch["bottlenecks"]
    state = state or [None] * len(arch["stage_dims"])
    with _precision(use_tf32):
        x, feats, new = frames.float(), [], []
        for k in range(1, len(arch["stage_dims"]) + 1):
            x, hc = stage(x, wt, k, arch, state[k - 1])
            new.append(hc)
            feats.append(x)
        x2, x1, x0 = feats[1:]

        def up(m):
            return F.interpolate(m, scale_factor=2, mode="nearest")

        fpn_out0 = base_conv(x0, wt, "conv_lat0", convs["conv_lat0"])
        f_out0 = csp_layer(torch.cat([up(fpn_out0), x1], 1), wt, "csp_p4", convs, n)
        fpn_out1 = base_conv(f_out0, wt, "conv_red1", convs["conv_red1"])
        pan_out2 = csp_layer(torch.cat([up(fpn_out1), x2], 1), wt, "csp_p3", convs, n)
        p_out1 = base_conv(pan_out2, wt, "conv_bu2", convs["conv_bu2"])
        pan_out1 = csp_layer(torch.cat([p_out1, fpn_out1], 1), wt, "csp_n3", convs, n)
        p_out0 = base_conv(pan_out1, wt, "conv_bu1", convs["conv_bu1"])
        pan_out0 = csp_layer(torch.cat([p_out0, fpn_out0], 1), wt, "csp_n4", convs, n)
        levels = []
        for s, feat in zip(arch["strides"], (pan_out2, pan_out1, pan_out0)):
            def conv(name, m):
                return base_conv(m, wt, f"conv_h{s}_{name}", convs[f"conv_h{s}_{name}"])

            stem = conv("stem", feat)
            cls = conv("cls", conv("c2", conv("c1", stem)))
            reg_feat = conv("r2", conv("r1", stem))
            out = torch.cat([conv("reg", reg_feat), conv("obj", reg_feat), cls], dim=1)
            levels.append(out.permute(0, 2, 3, 1))
    return levels, new


def forward(weights, arch, frames, state=None, use_tf32: bool = False):
    """Frames ``[S, T, C, H, W]``, time-major: :func:`step` at each of the
    ``T`` steps.  Returns the levels ``[S, T, gh, gw, 4 + 1 + classes]``
    and the state after the last step."""
    outs = []
    for t in range(frames.shape[1]):
        levels, state = step(weights, arch, frames[:, t], state, use_tf32)
        outs.append(levels)
    return [torch.stack(parts, dim=1) for parts in zip(*outs)], state


def decode(levels, strides=(8, 16, 32)):
    """YOLOX's decode: ``(boxes [..., N, 4]`` centre x, centre y, width,
    height in input pixels, ``scores [..., N]`` (objectness),
    ``class_probs [..., N, C])`` (class times objectness), the levels in
    order, each level's cells row by row."""
    boxes, scores, probs = [], [], []
    for out, s in zip(levels, strides):
        gh, gw = out.shape[-3:-1]
        ys, xs = torch.meshgrid(torch.arange(gh, device=out.device),
                                torch.arange(gw, device=out.device), indexing="ij")
        grid = torch.stack((xs, ys), dim=-1).float()
        xy = (out[..., :2] + grid) * s
        wh = torch.exp(out[..., 2:4]) * s
        obj = out[..., 4].sigmoid()
        lead = out.shape[:-3]
        boxes.append(torch.cat([xy, wh], dim=-1).reshape(*lead, -1, 4))
        scores.append(obj.reshape(*lead, -1))
        probs.append((out[..., 5:].sigmoid() * obj[..., None]).reshape(*lead, -1,
                                                                      out.shape[-1] - 5))
    return torch.cat(boxes, dim=-2), torch.cat(scores, dim=-1), torch.cat(probs, dim=-2)
