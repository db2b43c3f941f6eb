"""The 'full' conv stack: :func:`plan` cuts ``EventNetwork.
full_frame_forward``'s walk into steps, each a route and the one or two
layers it runs, and :data:`RUNS` holds one function a route.  A new route
is one case in :func:`_pair_route` and one function in :data:`RUNS`.

Each route runs in a frame of its own, so that no name in the walk keeps
a map alive past the step that replaces it.  The walk looks :func:`plan`
up here at each call: a test forces another device's routes by replacing
it.

RVT's layers run alone, one route each ('embed', 'attn', 'lstm', 'csp',
'yolox'), over :mod:`async_ev_cnn_torch.ops.rvt`.  Their maps between
steps may be channels-last in memory (``[N, C, H, W]`` views of ``[N, H,
W, C]`` tensors); a conv that E1 finishes takes its input contiguous.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import NamedTuple

import torch

from async_ev_cnn_torch.layers.types import LayerIO, LstmState
from async_ev_cnn_torch.ops import conv_pool, epilogue, fused_stem, layer_norm, rvt, stem
from async_ev_cnn_torch.ops.conv import conv2d_dense, tier_uses_tf32
from async_ev_cnn_torch.ops.pool import maxpool_dense


class Step(NamedTuple):
    """``route`` runs ``layers`` (one ``LayerDef``, or a conv and its pool),
    the first at ``start`` in ``event_layers[1:]``.  A 'stem' step keeps
    K6's weights in host memory (:func:`~async_ev_cnn_torch.ops.
    fused_stem.host_weights`), a 'conv_pool' step C1's packed weights
    (:func:`~async_ev_cnn_torch.ops.conv_pool.packed_weights`)."""

    route: str
    start: int
    layers: tuple
    weights: dict | None = None


class Maps(dict):
    """The maps that a later route or head reads, by layer name; and the
    walk's recurrent context: ``lead``, the frames' (streams, time steps),
    time-major (frame ``t * S + s``), and ``state``, the network's state as
    a list, whose LSTM entries the 'lstm' route replaces."""

    def __init__(self, lead: tuple[int, int], state):
        super().__init__()
        self.lead = lead
        self.state = list(state)


def plan(net, device=None, grad: bool = False, frames: int | None = None) -> tuple[Step, ...]:
    """``net``'s steps for a batch of ``frames`` maps on ``device`` (None:
    the CPU), ``grad`` whether the forward builds a graph for autograd
    (``network.needs_grad``); made once per (device type, grad, fusion,
    precision tier and, on a card, batch) and kept in the network.  On a
    card, a pair whose shape gives it C1 keeps the 'pooled' route for a
    batch where C1 would not give that route's numbers bit for bit
    (:func:`c1_gives_the_library`, a probe run once per pair and batch as
    the plan is made).  Without ``frames`` the plan probes nothing and
    gives the routes that the shapes allow."""
    kind = "cpu" if device is None else torch.device(device).type
    card = kind == "cuda" and not grad
    key = (kind, bool(grad), bool(net._s2d_pairs) and net._fusion_active(),
           tier_uses_tf32(), frames if card else None)
    steps = net._plans.get(key)
    if steps is None:
        layers, steps, i = net.event_layers[1:], [], 0
        while i < len(layers):
            route = _pair_route(net, layers, i, card=card, s2d=key[2])
            if (route == "conv_pool" and card and frames is not None
                    and not c1_gives_the_library(layers[i].spec, frames, device)):
                route = "pooled"
            size = 2 if route else 1
            steps.append(Step(route or layers[i].kind, i, tuple(layers[i:i + size]),
                              {} if route in ("stem", "conv_pool") else None))
            i += size
        steps = net._plans[key] = tuple(steps)
    return steps


def held_weights(net) -> tuple:
    """The kernels' weights that ``net``'s plans keep now (K6's taps, C1's
    packed weights: each step's cache entries), for a captured CUDA graph
    that reads them to hold: a step makes them anew for other weight
    tensors and drops the old, which the graph would read freed."""
    return tuple(entry for steps in net._plans.values() for step in steps if step.weights
                 for entry in step.weights.values())


#: the memory model's allowance (``EventNetwork.parallel_transient_bytes``)
#: for the workspace of a conv whose algorithm cuDNN times
#: (:func:`timed_algorithms`), beside its input and output
TIMED_WORKSPACE_BYTES = 1 << 30


def timed(ld) -> bool:
    """Whether cuDNN times the algorithms of layer ``ld``'s convs
    (:func:`timed_algorithms`): RVT's strided embeddings and YOLOX's SiLU
    convs, a CSP layer's included.  cuDNN's heuristic gives the YOLOX
    head's 3x3 128-channel SiLU convs over 1,024 frames an FFT 3.5x slower
    than its implicit GEMM.  The leaky convs (the eFCN's, YOLOv3-tiny's and
    YOLOX's linear outputs) keep the heuristic's choice, and with it their
    numbers."""
    return ld.kind in ("embed", "csp") or getattr(ld.spec, "act", None) == "silu"


@contextmanager
def timed_algorithms(on: bool):
    """Runs its block with cuDNN choosing each conv's algorithm by timing
    the candidates (``cudnn.benchmark``, once per shape) where ``on``; the
    flag is put back after."""
    if not on:
        yield
        return
    flag = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = flag


def _pair_route(net, layers, i: int, card: bool, s2d: bool) -> str | None:
    """The route of a pair that starts at layer ``i``, or None where the
    layer runs alone.  's2d' (one space-to-depth conv, ``ops/stem.py``)
    for the network's ``_s2d_pairs`` while they fuse; else 'pooled'
    (cuDNN's conv and the pooled epilogue E1, ``ops/epilogue.py``) for a
    'full' conv and a 2x2 stride-2 'full' pool of one activation dtype, an
    ``alpha`` that pools exactly and the conv's map kept for no route or
    head (the pair never stores it).  Of those, where ``card`` (a card, no
    gradient: K6 and C1 have no backward) and the conv is the s2d pair's
    3x3 SAME stride-1 conv over even dims: 'stem' (K6,
    ``ops/fused_stem.py``) for one input channel and at most
    ``STEM_MAX_O`` outputs, else 'conv_pool' (C1, ``ops/conv_pool.py``)
    for float32 activations at an IEEE float32 tier (C1 sums in float32;
    at the TF32 tier the library's numbers are TF32's)."""
    if s2d and i in net._s2d_pairs:
        return "s2d"
    if i + 1 == len(layers):
        return None
    conv, pool = layers[i], layers[i + 1]
    c, p = conv.spec, pool.spec
    if not (conv.kind == "conv" and pool.kind == "pool" and conv.name not in net._keep
            and c.mode == p.mode == "full" and tuple(p.ksize) == (2, 2) and p.stride == 2
            and c.act_dtype == p.act_dtype and c.act == "leaky"
            and epilogue.pools_exactly(c.alpha)):
        return None
    if card and stem.s2d_pair_applicable(c, p):
        if c.in_shape[0] == 1 and 1 <= c.out_channels <= fused_stem.STEM_MAX_O:
            return "stem"
        if c.act_dtype == "float32" and not tier_uses_tf32():
            return "conv_pool"
    return "pooled"


def c1_gives_the_library(spec, frames: int, device) -> bool:
    """Whether C1 gives, bit for bit, what the 'pooled' route gives for a
    batch of ``frames`` maps of conv ``spec``'s input on ``device``.  C1
    sums each output in cuDNN's implicit-GEMM order (input channel, then
    tap, from zero, by FMA), so it does wherever cuDNN runs an implicit
    GEMM.  Where cuDNN's heuristic picks another algorithm for the batch (an
    FFT: the eFCN's conv3 from 16 frames on, conv4 at 64, on the H100), the
    last bits differ, and the network's outputs with them; the pair then
    keeps the 'pooled' route, so no route changes a number the network
    gives.  cuDNN picks by shape, and PyTorch keeps its pick per shape, so
    one seeded probe of the batch's shape runs both, once; its launches
    count as any other.  Where the two differ, C1 must still lie within
    :func:`~async_ev_cnn_torch.ops.conv_pool.c1_bound` of its plain
    version (on the first and last maps) and within ``LIBRARY_REL`` of the
    library's largest value: else C1 is at fault, and this raises.

    A named debt (ROADMAP): this probe and the 'pooled' fallback go once
    the benchmark's ``out_gap`` limit is derived from C1's readings."""
    g = torch.Generator(device=device).manual_seed(0)
    c, o = spec.in_shape[0], spec.out_channels
    x = torch.rand((frames, *spec.in_shape), generator=g, device=device).sub_(0.5).clamp_(min=0)
    kernel = torch.randn((o, c, 3, 3), generator=g, device=device) * (2 / (9 * c)) ** 0.5
    bias = torch.randn(o, generator=g, device=device) * 0.1
    library = full_conv(spec, kernel, bias, x, pooled=True)
    c1 = conv_pool.conv_pool(x, kernel, bias, spec.alpha)
    if torch.equal(c1, library):
        return True
    gap = float((c1 - library).abs().max())
    ends = x[[0, -1]]
    plain = conv_pool.conv_pool_plain(ends, kernel, bias, spec.alpha)
    within = bool(((c1[[0, -1]].double() - plain.double()).abs()
                   <= conv_pool.c1_bound(ends, kernel, bias, plain)).all())
    if not within or gap > conv_pool.LIBRARY_REL * float(library.abs().max()):
        raise RuntimeError(
            f"C1 at {tuple(x.shape)} -> {spec.out_channels} channels is "
            f"{'within' if within else 'outside'} its bound of its plain version and "
            f"{gap:.3g} from the library pair, whose largest value is "
            f"{float(library.abs().max()):.3g}: the kernel is at fault")
    return False


def full_conv(spec, kernel, bias, x, pooled: bool = False) -> torch.Tensor:
    """A 'full' conv of ``x`` (the 'conv' and 'pooled' routes, and the
    sequential engine's 'full' conv): cuDNN's conv, then its bias, the
    activation (``spec.act``), the cast to ``spec.act_dtype`` (to nearest
    even, as ``astype`` rounds to bf16) and, ``pooled``, the 2x2 pool, in
    one :func:`~async_ev_cnn_torch.ops.epilogue.conv_epilogue`."""
    with timed_algorithms(spec.act == "silu"):
        raw = conv2d_dense(x.contiguous(), kernel, None, spec.stride, spec.padding)
    if spec.act != "leaky":
        return epilogue.conv_epilogue(raw, bias, spec.alpha, spec.act_dtype, act=spec.act)
    return epilogue.conv_epilogue(raw, bias, spec.alpha, spec.act_dtype, pooled=pooled)


def full_pool(spec, x) -> torch.Tensor:
    """A 'full' pool: the dense max over the *activated* map (the activation
    is monotone, so it is the activated value at the window argmax), exact
    in bf16."""
    return maxpool_dense(x, spec.ksize, spec.stride, spec.padding).to(
        getattr(torch, spec.act_dtype))


# ---- the routes: (net, params, step, x, kept) -> the step's map, from
# ``x``, the previous step's map, and ``kept``, the maps that a later route
# or head reads, by layer name

def _conv_args(net, params, ld, x):
    """Conv ``ld``'s spec and weights and the map it reads (a model rank
    gathers the other ranks' channels: ``parallel.streams``)."""
    return (ld.spec, params[f"w_{ld.name}"], params[f"b_{ld.name}"],
            net._conv_input(ld, LayerIO(x, None, None, None)).featuremap)


def run_s2d(net, params, step, x, kept):
    spec, w, b, x = _conv_args(net, params, step.layers[0], x)
    # one cast of the pooled map: the conv's own is never stored
    return stem.fused_conv_pool(x, w, b, spec.alpha).to(
        getattr(torch, step.layers[1].spec.act_dtype))


def run_stem(net, params, step, x, kept):
    spec, w, b, x = _conv_args(net, params, step.layers[0], x)
    taps, bias = fused_stem.host_weights(step.weights, step.layers[0].name, w, b)
    fm = fused_stem.fused_stem(x.float().reshape(-1, *x.shape[-2:]).contiguous(), taps, bias,
                               spec.alpha)
    return fm.reshape(*x.shape[:-3], *fm.shape[-3:]).to(
        getattr(torch, step.layers[1].spec.act_dtype))


def run_conv_pool(net, params, step, x, kept):
    spec, w, b, x = _conv_args(net, params, step.layers[0], x)
    fm = conv_pool.conv_pool(x.reshape(-1, *x.shape[-3:]).contiguous(), w, b, spec.alpha,
                             conv_pool.packed_weights(step.weights, step.layers[0].name, w, b))
    return fm.reshape(*x.shape[:-3], *fm.shape[-3:])


def run_pooled(net, params, step, x, kept):
    return full_conv(*_conv_args(net, params, step.layers[0], x), pooled=True)


def run_conv(net, params, step, x, kept):
    return full_conv(*_conv_args(net, params, step.layers[0], x))


def run_pool(net, params, step, x, kept):
    return full_pool(step.layers[0].spec, x)


def run_route(net, params, step, x, kept):
    """Its one map, or its maps ``[(N,) C_i, H, W]`` concatenated over
    channels in order."""
    parts = [kept[name] for name in step.layers[0].spec.sources]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-3)


def run_upsample(net, params, step, x, kept):
    """Each value of ``x`` repeated over a ``factor x factor`` block (exact
    in any dtype)."""
    f = step.layers[0].spec.factor
    return x.repeat_interleave(f, dim=-2).repeat_interleave(f, dim=-1)


def run_yolo(net, params, step, x, kept):
    """The head's grid, float32 whatever the activation dtype; the walk's
    map stays ``x``."""
    return kept[step.layers[0].spec.source].movedim(-3, -1).float()


def run_embed(net, params, step, x, kept):
    """RVT's patch embedding: the strided conv (no bias), then the
    LayerNorm over channels (L1, which reads the conv's map in whichever
    layout cuDNN gave it); channels-last in memory."""
    ld = step.layers[0]
    with timed_algorithms(True):
        y = conv2d_dense(x, params[f"w_{ld.name}"], None, ld.spec.stride, "HALF")
    y = layer_norm.layer_norm(y.permute(0, 2, 3, 1), params[f"ln_g_{ld.name}"],
                              params[f"ln_b_{ld.name}"], rvt.LN_EPS)
    return y.permute(0, 3, 1, 2)


def run_attn(net, params, step, x, kept):
    """A MaxViT pair over every frame, added into the map in place (into a
    copy where a later route reads the map)."""
    ld = step.layers[0]
    y = x.permute(0, 2, 3, 1)
    if not y.is_contiguous():
        y = y.contiguous()
    elif any(y.data_ptr() == k.data_ptr() for k in kept.values()):
        y = y.clone()
    return rvt.maxvit_pair(y, params, ld.name, ld.spec).permute(0, 3, 1, 2)


def run_lstm(net, params, step, x, kept):
    """The ConvLSTM as a scan over the time steps of ``kept.lead`` (the
    frames time-major), from the layer's state in ``kept.state``, which it
    replaces; counts the steps in ``net.layer_counts``."""
    ld = step.layers[0]
    s, t = kept.lead
    c, h, w = ld.spec.in_shape
    st = kept.state[1 + step.start]
    shape = st.h.shape

    def rows(m):  # a state map [(S,) C, H, W] as [S * H * W, C]
        return m.reshape(s, c, h * w).transpose(1, 2).reshape(s * h * w, c)

    seq, hn, cn = rvt.lstm_scan(x.permute(0, 2, 3, 1).reshape(t, s * h * w, c),
                                rows(st.h), rows(st.c), params[f"w_{ld.name}"],
                                params[f"b_{ld.name}"])

    def back(m):  # [S * H * W, C] -> the state's shape, channels-last in memory
        return m.view(s, h, w, c).permute(0, 3, 1, 2).reshape(shape)

    kept.state[1 + step.start] = LstmState(back(hn), back(cn))
    net.layer_counts[ld.name]["recurrent_steps"] += t
    return seq.view(t * s, h, w, c).permute(0, 3, 1, 2)


def run_csp(net, params, step, x, kept):
    """YOLOX's CSP layer: each conv cuDNN's, finished by E1's SiLU form."""
    ld = step.layers[0]
    convs = ld.spec.convs

    def conv(key, m):
        return full_conv(convs[key], params[f"w_{ld.name}_{key}"], params[f"b_{ld.name}_{key}"],
                         m)

    a, b = conv("c1", x), conv("c2", x)
    for i in range(ld.spec.depth):
        a = conv(f"m{i}b", conv(f"m{i}a", a))
    return conv("c3", torch.cat([a, b], dim=-3))


def run_yolox(net, params, step, x, kept):
    """A YOLOX level's raw output ``[N, h, w, 4 + 1 + classes]``: its box,
    objectness and class maps, channels last; the walk's map stays ``x``."""
    parts = [kept[name] for name in step.layers[0].spec.sources]
    return torch.cat(parts, dim=-3).movedim(-3, -1).float()


#: each route's function
RUNS = {"s2d": run_s2d, "stem": run_stem, "conv_pool": run_conv_pool, "pooled": run_pooled,
        "conv": run_conv, "pool": run_pool, "route": run_route, "upsample": run_upsample,
        "yolo": run_yolo, "embed": run_embed, "attn": run_attn, "lstm": run_lstm,
        "csp": run_csp, "yolox": run_yolox}
