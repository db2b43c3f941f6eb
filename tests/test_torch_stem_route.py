"""Which conv+pool pairs of a 'full' network run as the fused stem K6
(ops/fused_stem.py) and which keep cuDNN's conv and the pooled epilogue
(layers/conv_stack.plan), and that the CPU path is unchanged.

K6 takes a pair where it fuses under the epilogue, its conv reads one
channel through a 3x3 SAME kernel at stride 1 into 1 to STEM_MAX_O
channels over even dims, its output is kept for no route or head, the
tensors are on the card and no gradient is needed; an active
space-to-depth pair takes precedence.  The predicate is read here with a
card device named, which needs no card.  On the CPU the path is the
unfused layers' composition bit for bit, as before the route existed;
the 'stem' route itself is run on the CPU by forcing it (the plan of a
card in place of the CPU's), where K6's wrapper runs its plain version.
Each route's run function is held to the layers it replaces, step by step.
"""

import weakref

import numpy as np
import pytest
import torch
import yaml

from async_ev_cnn_torch.layers import conv_stack, network
from async_ev_cnn_torch.layers.conv2d import conv_step
from async_ev_cnn_torch.layers.maxpool import pool_step
from async_ev_cnn_torch.layers.network import EventNetwork, needs_grad
from async_ev_cnn_torch.layers.types import LayerIO
from async_ev_cnn_torch.ops import conv as tconv
from async_ev_cnn_torch.ops import epilogue
from async_ev_cnn_torch.ops import fused_stem as tf
from async_ev_cnn_torch.ops import pool as tpool
from async_ev_cnn_torch.ops import stem as tstem
from async_ev_cnn_torch.utils import profiling
from async_ev_cnn_torch.utils.config import layers_dict
from async_ev_cnn_torch.utils.weights import fold_batchnorm
from reference import yolov3_tiny as ref

torch.set_num_threads(2)

EFCN_YML = "configs/efcn_event_full.yml"
YOLO_YML = "async_ev_cnn_torch/configs/yolov3_tiny_event.yml"
K6_TOL = tf.K6_TOL


def _yml(path) -> dict:
    with open(path) as fh:
        return yaml.safe_load(fh)


def _yml_net(path, **kw) -> EventNetwork:
    cfg = _yml(path)
    return EventNetwork(layers_dict(cfg["yolo_cnn_layers"]), cfg["frame_h"], cfg["frame_w"],
                        cfg["leak"], 0.1, cfg["yolo_cnn_padding"], conv_mode="full", **kw)


def _dsl_net(dsl, h=24, w=32, alpha=0.1, **kw) -> EventNetwork:
    return EventNetwork(layers_dict(dsl), h, w, 1e-4, alpha, "SAME", conv_mode="full", **kw)


def _params(net, seed=0, requires_grad=False):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for ld in net.event_layers:
        if ld.kind == "conv":
            cin, (kh, kw), cout = ld.spec.in_shape[0], ld.spec.ksize, ld.spec.out_channels
            out[f"w_{ld.name}"] = torch.randn(cout, cin, kh, kw, generator=g) * 0.3
            out[f"b_{ld.name}"] = torch.randn(cout, generator=g) * 0.1
    return {k: v.requires_grad_(requires_grad) for k, v in out.items()}


def _stride_2_conv1(monkeypatch):
    """build_layer_defs with conv1 at stride 2 (the DSL has no conv stride)."""
    build = network.build_layer_defs

    def strided(*args, **kw):
        layers, tail = build(*args, **kw)
        ld = layers[1]
        return [layers[0], ld._replace(spec=ld.spec._replace(stride=2)), *layers[2:]], tail

    monkeypatch.setattr(network, "build_layer_defs", strided)


# (id, how the net is built, the autograd setup, {conv of each pair: the kind it runs})
PAIR_CASES = [
    ("efcn", lambda: _yml_net(EFCN_YML), None,
     {"conv1": "stem", "conv2": "pooled", "conv3": "pooled", "conv4": "pooled",
      "conv5": "pooled"}),
    ("efcn_bf16", lambda: _yml_net(EFCN_YML, activation_dtype="bfloat16"), None,
     {"conv1": "stem", "conv2": "pooled", "conv3": "pooled", "conv4": "pooled",
      "conv5": "pooled"}),
    ("yolov3_tiny", lambda: _yml_net(YOLO_YML, stem_fusion=False), None,
     {"conv0": "stem", "conv2": "pooled", "conv4": "pooled", "conv6": "pooled"}),
    ("two_input_channels", lambda: _dsl_net("conv1=3,3,2,8 pool1=2,2 conv2=3,3,8,8 pool2=2,2"),
     None, {"conv1": "pooled", "conv2": "pooled"}),
    ("5x5_stem", lambda: _dsl_net("conv1=5,5,1,8 pool1=2,2 conv2=3,3,8,8 pool2=2,2"), None,
     {"conv1": "pooled", "conv2": "pooled"}),
    ("alpha_0", lambda: _dsl_net("conv1=3,3,1,8 pool1=2,2 conv2=3,3,8,8 pool2=2,2", alpha=0.0),
     None, {}),
    ("stride_2", "stride_2", None, {"conv1": "pooled", "conv2": "pooled"}),
    ("stem_routed", lambda: _dsl_net(
        "conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,8 pool2=2,2 route3=conv1 conv4=1,1,4,4"), None,
     {"conv2": "pooled"}),
    ("o_past_the_struct", lambda: _dsl_net(
        f"conv1=3,3,1,{tf.STEM_MAX_O + 1} pool1=2,2"), None, {"conv1": "pooled"}),
    ("odd_width", lambda: _dsl_net("conv1=3,3,1,8 pool1=2,2", w=33), None,
     {"conv1": "pooled"}),
    ("s2d_at_highest", lambda: _yml_net(EFCN_YML, stem_fusion=True), None,
     {"conv1": "s2d", "conv2": "pooled", "conv3": "pooled", "conv4": "pooled",
      "conv5": "pooled"}),
    ("autograd_params", lambda: _yml_net(EFCN_YML), "params",
     {"conv1": "pooled", "conv2": "pooled", "conv3": "pooled", "conv4": "pooled",
      "conv5": "pooled"}),
    ("autograd_frame", lambda: _yml_net(EFCN_YML), "frame",
     {"conv1": "pooled", "conv2": "pooled", "conv3": "pooled", "conv4": "pooled",
      "conv5": "pooled"}),
    ("params_track_grad_mode_off", lambda: _yml_net(EFCN_YML), "no_grad",
     {"conv1": "stem", "conv2": "pooled", "conv3": "pooled", "conv4": "pooled",
      "conv5": "pooled"}),
]


@pytest.mark.parametrize("make,autograd,want", [c[1:] for c in PAIR_CASES],
                         ids=[c[0] for c in PAIR_CASES])
def test_each_pair_runs_the_kind_its_shape_and_device_give(monkeypatch, make, autograd, want):
    tconv.set_matmul_precision("highest")
    if make == "stride_2":
        _stride_2_conv1(monkeypatch)
        net = _dsl_net("conv1=3,3,1,8 pool1=2,2 conv2=3,3,8,8 pool2=2,2")
    else:
        net = make()
    params = _params(net, requires_grad=autograd in ("params", "no_grad"))
    _, h, w = net.event_layers[0].spec.out_shape
    frame = torch.zeros(1, 1, h, w, requires_grad=autograd == "frame")
    if autograd == "no_grad":
        with torch.no_grad():
            grad = needs_grad(frame, params)
    else:
        grad = needs_grad(frame, params)
    assert grad == (autograd in ("params", "frame"))
    names = [ld.name for ld in net.event_layers[1:]]

    def kinds(device):
        steps = conv_stack.plan(net, device, grad)
        assert [ld.name for s in steps for ld in s.layers] == names  # each layer once, in order
        return {s.layers[0].name: s.route for s in steps if len(s.layers) == 2}

    assert kinds("cuda") == want
    assert kinds(torch.device("cuda", 0)) == want
    # on the CPU no pair takes K6: the ones it would take keep the epilogue
    assert kinds("cpu") == {n: "pooled" if k == "stem" else k for n, k in want.items()}
    assert kinds(None) == kinds("cpu")


def _pairs(net, device):
    """(route, start) of each step of two layers in ``net``'s plan."""
    return [(s.route, s.start) for s in conv_stack.plan(net, device) if len(s.layers) == 2]


def _card_plan(monkeypatch):
    """Force the routes of a card on the CPU: the walk's plan is the one a
    card gets, so K6's route runs its wrapper's plain version."""
    real = conv_stack.plan
    monkeypatch.setattr(conv_stack, "plan",
                        lambda net, device=None, grad=False: real(net, "cuda", grad))


def unfused_walk(net, params, frames):
    """The unfused layers, composed: conv2d_dense with its bias, leaky, the
    cast to the activation dtype, the pools, routes, upsampling and heads
    of the graph.  Before the fused stem existed, full_frame_forward on
    the CPU gave exactly this."""
    x, kept, grids = frames, {}, []
    for ld in net.event_layers[1:]:
        if ld.kind == "conv":
            x = tconv.leaky(tconv.conv2d_dense(x, params[f"w_{ld.name}"], params[f"b_{ld.name}"],
                                               ld.spec.stride, ld.spec.padding), ld.spec.alpha)
            x = x.to(getattr(torch, ld.spec.act_dtype))
        elif ld.kind == "pool":
            x = tpool.maxpool_dense(x, ld.spec.ksize, ld.spec.stride, ld.spec.padding)
        elif ld.kind == "route":
            x = torch.cat([kept[s] for s in ld.spec.sources], dim=-3)
        elif ld.kind == "upsample":
            f = ld.spec.factor
            x = x.repeat_interleave(f, dim=-2).repeat_interleave(f, dim=-1)
        else:
            grids.append(kept[ld.spec.source].movedim(-3, -1).float())
        kept[ld.name] = x
    return tuple(grids) if net.heads else net.apply_tail(params, x.movedim(-3, -1))


def _tiny_yolo(stem_fusion=False):
    layers = ref.darknet_layers(div=16)
    dsl = " ".join(
        f"conv{i}={la['size']},{la['size']},{la['in']},{la['filters']}"
        + ("" if la["bn"] else "@linear") if la["kind"] == "conv"
        else f"pool{i}=2,2" + (",1" if la["stride"] == 1 else "") if la["kind"] == "maxpool"
        else f"yolo{i}=conv{i - 1}" if la["kind"] == "yolo"
        else f"route{i}=" + ",".join(
            f"{'upsample' if layers[j]['kind'] == 'upsample' else 'conv'}{j}"
            for j in la["layers"]) if la["kind"] == "route"
        else f"upsample{i}={la['stride']}"
        for i, la in enumerate(layers))
    net = EventNetwork(layers_dict(dsl), 64, 64, 5e-5, 0.1, "SAME", conv_mode="full",
                       stem_fusion=stem_fusion)
    g = torch.Generator().manual_seed(5)
    w = {}
    for i, la in enumerate(layers):
        if la["kind"] != "conv":
            continue
        k, cin, cout = la["size"], la["in"], la["filters"]
        w[f"w_conv{i}"] = torch.randn(cout, cin, k, k, generator=g) * (2 / (cin * k * k)) ** 0.5
        stats = ("gamma", "var", "beta", "mean") if la["bn"] else ("b",)
        for stat in stats:
            w[f"{stat}_conv{i}"] = (torch.rand(cout, generator=g) + 0.5 if stat in ("gamma", "var")
                                    else torch.randn(cout, generator=g) * 0.1)
    return net, fold_batchnorm(w)


@pytest.mark.parametrize("model", ["efcn", "yolov3_tiny"])
def test_full_frame_forward_on_the_cpu_is_the_unfused_walk_bit_for_bit(model):
    tconv.set_matmul_precision("highest")
    if model == "efcn":
        net = EventNetwork(layers_dict(_yml(EFCN_YML)["yolo_cnn_layers"]), 32, 48, 5e-5, 0.1,
                           "SAME", conv_mode="full")
        params, (h, w) = _params(net, seed=3), (32, 48)
    else:
        (net, params), (h, w) = _tiny_yolo(), (64, 64)
    g = torch.Generator().manual_seed(11)
    frames = torch.rand(3, 1, h, w, generator=g) * (torch.rand(3, 1, h, w, generator=g) < 0.3)
    tf.reset_launches()
    epilogue.reset_launches()
    got = net.full_frame_forward(params, net.init_state(params, "cpu"), frames)
    want = unfused_walk(net, params, frames)
    for a, b in zip(got if net.heads else (got,), want if net.heads else (want,)):
        assert a.shape == b.shape and torch.equal(a, b)
    assert tf.LAUNCHES["fused_stem"] == 0 and epilogue.LAUNCHES["conv_epilogue"] == 0


def _layerwise(params, step, x, kept):
    """What the walk computed for a step's layers before the plan existed,
    on the CPU: conv_step and pool_step one layer at a time ('conv',
    'pool', and 'pooled' composed), K6's plain version for a 'stem' pair,
    fused_conv_pool for an 's2d' pair, the concatenation of a route, the
    repeated values of an upsampling and a head's float32 grid."""
    ld = step.layers[0]
    if step.route in ("stem", "s2d"):
        w, b = params[f"w_{ld.name}"], params[f"b_{ld.name}"]
        act = getattr(torch, step.layers[1].spec.act_dtype)
        if step.route == "s2d":
            return tstem.fused_conv_pool(x, w, b, ld.spec.alpha).to(act)
        fm = tf.fused_stem_plain(x.reshape(-1, *x.shape[-2:]), tf.w_taps_from_oihw(w), b,
                                 ld.spec.alpha)
        return fm.reshape(*x.shape[:-3], *fm.shape[-3:]).to(act)
    if step.route == "route":
        parts = [kept[name] for name in ld.spec.sources]
        return torch.cat(parts, dim=-3) if len(parts) > 1 else parts[0]
    if step.route == "upsample":
        f = ld.spec.factor
        *lead, c, h, w = x.shape
        return x[..., None, :, None].expand(*lead, c, h, f, w, f).reshape(*lead, c, h * f, w * f)
    if step.route == "yolo":
        return kept[ld.spec.source].movedim(-3, -1).float()
    io = LayerIO(x, None, None, None)
    for layer in step.layers:
        if layer.kind == "conv":
            _, io = conv_step(layer.spec, params[f"w_{layer.name}"], params[f"b_{layer.name}"],
                              None, io, 0.0)
        else:
            _, io = pool_step(layer.spec, None, io, 0.0)
    return io.featuremap


# (model, forced routes, the routes its plan takes)
ROUTE_CASES = [
    ("efcn", "cpu", {"pooled", "conv"}),
    ("efcn", "k6", {"stem", "pooled", "conv"}),
    ("efcn", "s2d", {"s2d", "pooled", "conv"}),
    ("yolov3_tiny", "cpu", {"pooled", "conv", "pool", "route", "upsample", "yolo"}),
    ("yolov3_tiny", "k6", {"stem", "pooled", "conv", "pool", "route", "upsample", "yolo"}),
    ("yolov3_tiny", "s2d", {"s2d", "pooled", "conv", "pool", "route", "upsample", "yolo"}),
]


@pytest.mark.parametrize("model,force,routes", ROUTE_CASES,
                         ids=[f"{m}-{f}" for m, f, _ in ROUTE_CASES])
def test_each_route_is_the_layers_it_replaces(monkeypatch, model, force, routes):
    """Every step of the plan, run by its route's function, is
    ``torch.equal`` to the same layers computed one at a time as before the
    plan existed; and the walk over the plan gives the composition's
    output.  'k6' forces the routes of a card, 's2d' fuses the stem by
    space-to-depth (``stem_fusion=True`` at 'highest')."""
    tconv.set_matmul_precision("highest")
    if model == "efcn":
        net = EventNetwork(layers_dict(_yml(EFCN_YML)["yolo_cnn_layers"]), 32, 48, 5e-5, 0.1,
                           "SAME", conv_mode="full", stem_fusion=force == "s2d")
        params, (h, w) = _params(net, seed=8), (32, 48)
    else:
        (net, params), (h, w) = _tiny_yolo(stem_fusion=force == "s2d"), (64, 64)
    if force == "k6":
        _card_plan(monkeypatch)
    g = torch.Generator().manual_seed(12)
    frames = torch.rand(2, 1, h, w, generator=g) * (torch.rand(2, 1, h, w, generator=g) < 0.3)
    steps = conv_stack.plan(net, "cpu")
    assert {s.route for s in steps} == routes
    x, kept, grids = frames, {}, []
    for step in steps:
        got = conv_stack.RUNS[step.route](net, params, step, x, kept)
        want = _layerwise(params, step, x, kept)
        assert got.dtype == want.dtype and torch.equal(got, want), step.route
        if step.route == "yolo":
            grids.append(want)
        else:
            x = want
        kept[step.layers[-1].name] = x
    out = net.full_frame_forward(params, net.init_state(params, "cpu"), frames)
    want = tuple(grids) if net.heads else (net.apply_tail(params, x.movedim(-3, -1)),)
    out = out if net.heads else (out,)
    assert len(out) == len(want) and all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batched", [True, False])
def test_the_stem_branch_forced_on_the_cpu_is_k6s_plain_version(monkeypatch, act_dtype,
                                                                batched):
    """The 'stem' branch of full_frame_forward, run on the CPU: K6's plain
    version in a ``conv.stem`` span inside ``layer.conv1``, pool1 with no
    span of its own, the output cast once to the activation dtype, within
    K6's tolerance of the unfused layers."""
    net = _dsl_net("conv1=3,3,1,8 pool1=2,2 conv2=3,3,8,8 pool2=2,2 conv3=1,1,8,6",
                   h=20, w=28, activation_dtype=act_dtype)
    assert _pairs(net, "cuda") == [("stem", 0), ("pooled", 2)]
    assert _pairs(net, "cpu") == [("pooled", 0), ("pooled", 2)]
    _card_plan(monkeypatch)
    params = _params(net, seed=2)
    g = torch.Generator().manual_seed(2)
    frames = torch.rand(4, 1, 20, 28, generator=g)
    state = net.init_state(params, "cpu")
    x = frames if batched else frames[1]
    with profiling.recording():
        profiling.clear()
        stem_map = net.full_frame_forward(params, state, x, upto=2)
        spans = profiling.recorded()
    names = [s[0] for s in spans]
    assert names == ["scan.conv_stack", "layer.conv1", "conv.stem"]
    assert spans[2][3] == 1  # conv.stem lies inside layer.conv1
    taps = tf.w_taps_from_oihw(params["w_conv1"])
    plain = tf.fused_stem_plain(x.reshape(-1, 20, 28), taps, params["b_conv1"], 0.1)
    act = getattr(torch, act_dtype)
    assert stem_map.dtype == act and torch.equal(stem_map, plain.reshape(stem_map.shape).to(act))
    library = tpool.maxpool_dense(tconv.leaky(tconv.conv2d_dense(
        x, params["w_conv1"], params["b_conv1"], 1, "SAME"), 0.1), (2, 2), 2, "VALID")
    err = float((plain.reshape(library.shape) - library).abs().max())
    assert err <= K6_TOL * (1 + float(library.abs().max()))
    out = net.full_frame_forward(params, state, x)
    want = unfused_walk(net, params, x)
    assert out.shape == want.shape
    assert float((out - want).abs().max()) <= 1e-5 * (1 + float(want.abs().max()))


def test_the_walk_keeps_no_pooled_stem_map_past_the_layer_that_reads_it(monkeypatch):
    """The 'stem' branch, forced on the CPU: once conv2's pair has replaced
    the stem's pooled map, nothing in the walk keeps it alive (a name left
    bound to it would hold a [N, O, H/2, W/2] map, 2.8 GB at YOLOv3-tiny's
    1,024 frames, through the rest of the network)."""
    net = _dsl_net("conv1=3,3,1,8 pool1=2,2 conv2=3,3,8,8 pool2=2,2 conv3=1,1,8,6", h=20, w=28)
    _card_plan(monkeypatch)
    stems, alive_at_conv3 = [], []
    stem_call, epilogue_call = tf.fused_stem, epilogue.conv_epilogue

    def stem_spy(*args):
        out = stem_call(*args)
        stems.append(weakref.ref(out))
        return out

    def epilogue_spy(x, bias, alpha, act_dtype="float32", pooled=False):
        if not pooled:  # conv3, the conv after conv2's pair
            alive_at_conv3.append(stems[0]() is not None)
        return epilogue_call(x, bias, alpha, act_dtype, pooled)

    monkeypatch.setattr(tf, "fused_stem", stem_spy)
    monkeypatch.setattr(epilogue, "conv_epilogue", epilogue_spy)
    params = _params(net, seed=6)
    net.full_frame_forward(params, net.init_state(params, "cpu"), torch.rand(3, 1, 20, 28))
    assert len(stems) == 1 and alive_at_conv3 == [False]


def test_the_host_weights_are_made_once_a_weight_tensor():
    g = torch.Generator().manual_seed(9)
    kernel, bias = torch.randn(16, 1, 3, 3, generator=g), torch.randn(16, generator=g)
    cache = {}
    taps, b = tf.host_weights(cache, "conv1", kernel, bias)
    assert taps.device.type == b.device.type == "cpu" and taps.shape == (9, 16)
    assert torch.equal(taps, tf.w_taps_from_oihw(kernel)) and torch.equal(b, bias)
    again = tf.host_weights(cache, "conv1", kernel, bias)
    assert again[0] is taps and again[1] is b  # found, not made again
    kernel.mul_(2)  # a write in place bumps the version: made again
    taps2, _ = tf.host_weights(cache, "conv1", kernel, bias)
    assert taps2 is not taps and torch.equal(taps2, tf.w_taps_from_oihw(kernel))
    other = bias.clone()  # another tensor, equal values: made again
    assert tf.host_weights(cache, "conv1", kernel, other)[1] is not b
    with torch.inference_mode():
        k_inf, b_inf = kernel.clone(), bias.clone()
    first = tf.host_weights(cache, "conv1", k_inf, b_inf)
    assert tf.host_weights(cache, "conv1", k_inf, b_inf)[0] is not first[0]


def test_the_wrapper_takes_host_weights_with_an_input_on_the_cpu():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.rand(2, 6, 8).astype(np.float32))
    taps = torch.from_numpy(rng.randn(9, 3).astype(np.float32))
    b = torch.from_numpy(rng.randn(3).astype(np.float32))
    with profiling.recording():
        profiling.clear()
        got = tf.fused_stem(x, taps, b, 0.1)
        assert [s[0] for s in profiling.recorded()] == ["conv.stem"]
    assert torch.equal(got, tf.fused_stem_plain(x, taps, b, 0.1))
    meta = torch.empty(9, 3, device="meta")
    with pytest.raises(ValueError, match="all lie on the CPU or all on the card"):
        tf.fused_stem(x, meta, b, 0.1)
