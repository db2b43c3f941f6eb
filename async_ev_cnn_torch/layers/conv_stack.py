"""The 'full' conv stack: :func:`plan` cuts ``EventNetwork.
full_frame_forward``'s walk into steps, each a route and the one or two
layers it runs, and :data:`RUNS` holds one function a route.  A new route
is one case in :func:`_pair_route` and one function in :data:`RUNS`.

Each route runs in a frame of its own, so that no name in the walk keeps
a map alive past the step that replaces it.  The walk looks :func:`plan`
up here at each call: a test forces another device's routes by replacing
it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from async_ev_cnn_torch.layers.types import LayerIO
from async_ev_cnn_torch.ops import epilogue, fused_stem, stem
from async_ev_cnn_torch.ops.conv import conv2d_dense
from async_ev_cnn_torch.ops.pool import maxpool_dense


class Step(NamedTuple):
    """``route`` runs ``layers`` (one ``LayerDef``, or a conv and its pool),
    the first at ``start`` in ``event_layers[1:]``.  A 'stem' step keeps
    K6's weights in host memory (:func:`~async_ev_cnn_torch.ops.
    fused_stem.host_weights`)."""

    route: str
    start: int
    layers: tuple
    weights: dict | None = None


def plan(net, device=None, grad: bool = False) -> tuple[Step, ...]:
    """``net``'s steps for frames on ``device`` (None: the CPU), ``grad``
    whether the forward builds a graph for autograd (``network.
    needs_grad``); made once per (device type, grad, fusion) and kept in
    the network."""
    kind = "cpu" if device is None else torch.device(device).type
    key = (kind, bool(grad), bool(net._s2d_pairs) and net._fusion_active())
    steps = net._plans.get(key)
    if steps is None:
        layers, steps, i = net.event_layers[1:], [], 0
        while i < len(layers):
            route = _pair_route(net, layers, i, k6=kind == "cuda" and not grad, s2d=key[2])
            size = 2 if route else 1
            steps.append(Step(route or layers[i].kind, i, tuple(layers[i:i + size]),
                              {} if route == "stem" else None))
            i += size
        steps = net._plans[key] = tuple(steps)
    return steps


def _pair_route(net, layers, i: int, k6: bool, s2d: bool) -> str | None:
    """The route of a pair that starts at layer ``i``, or None where the
    layer runs alone.  's2d' (one space-to-depth conv, ``ops/stem.py``)
    for the network's ``_s2d_pairs`` while they fuse; else 'pooled'
    (cuDNN's conv and the pooled epilogue E1, ``ops/epilogue.py``) for a
    'full' conv and a 2x2 stride-2 'full' pool of one activation dtype, an
    ``alpha`` that pools exactly and the conv's map kept for no route or
    head (the pair never stores it); of those, 'stem' (K6,
    ``ops/fused_stem.py``) where ``k6`` (a card, no gradient: K6 has no
    backward) for one input channel, the s2d pair's 3x3 SAME stride-1 conv
    over even dims and at most ``STEM_MAX_O`` outputs."""
    if s2d and i in net._s2d_pairs:
        return "s2d"
    if i + 1 == len(layers):
        return None
    conv, pool = layers[i], layers[i + 1]
    c, p = conv.spec, pool.spec
    if not (conv.kind == "conv" and pool.kind == "pool" and conv.name not in net._keep
            and c.mode == p.mode == "full" and tuple(p.ksize) == (2, 2) and p.stride == 2
            and c.act_dtype == p.act_dtype and epilogue.pools_exactly(c.alpha)):
        return None
    if (k6 and c.in_shape[0] == 1 and 1 <= c.out_channels <= fused_stem.STEM_MAX_O
            and stem.s2d_pair_applicable(c, p)):
        return "stem"
    return "pooled"


def full_conv(spec, kernel, bias, x, pooled: bool = False) -> torch.Tensor:
    """A 'full' conv of ``x`` (the 'conv' and 'pooled' routes, and the
    sequential engine's 'full' conv): cuDNN's conv, then its bias, the
    activation, the cast to ``spec.act_dtype`` (to nearest even, as
    ``astype`` rounds to bf16) and, ``pooled``, the 2x2 pool, in one
    :func:`~async_ev_cnn_torch.ops.epilogue.conv_epilogue`."""
    return epilogue.conv_epilogue(conv2d_dense(x, kernel, None, spec.stride, spec.padding),
                                  bias, spec.alpha, spec.act_dtype, pooled=pooled)


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


#: each route's function
RUNS = {"s2d": run_s2d, "stem": run_stem, "pooled": run_pooled, "conv": run_conv,
        "pool": run_pool, "route": run_route, "upsample": run_upsample, "yolo": run_yolo}
