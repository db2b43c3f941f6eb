"""The conv epilogue (async_ev_cnn_torch/ops/epilogue.py) and where the
parallel path takes it (EventNetwork.full_frame_forward's conv+pool pairs,
conv2d._full_io for every other 'full' conv).

On the CPU the wrapper runs its plain version, the unfused layers' eager
sequence, so every comparison here is bit for bit.  The kernel's own order
(pool the raw conv output, then add the bias and activate) is emulated with
the same float32 operations and held to the unfused result value for value
(``torch.equal``: a zero's sign aside), which is what the kernel is held to
on the card (tests/test_torch_conv_epilogue_chip.py).
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from async_ev_cnn_torch.layers.network import EventNetwork
from async_ev_cnn_torch.layers.types import EventChunk
from async_ev_cnn_torch.ops import conv as tconv
from async_ev_cnn_torch.ops import epilogue
from async_ev_cnn_torch.ops import pool as tpool
from async_ev_cnn_torch.ops.integrate import integrate_parallel
from async_ev_cnn_torch.ops.numerics import float32_scalar
from async_ev_cnn_torch.utils import profiling
from async_ev_cnn_torch.utils.config import layers_dict
from async_ev_cnn_torch.utils.runner import pack_chunks

torch.set_num_threads(2)

# the eFCN's convs (configs/efcn_event.yml): (name, Cin, Cout, k, H, W, pooled)
EFCN = [("conv1", 1, 16, 3, 160, 224, True), ("conv2", 16, 32, 3, 80, 112, True),
        ("conv3", 32, 64, 3, 40, 56, True), ("conv4", 64, 128, 3, 20, 28, True),
        ("conv5", 128, 256, 3, 10, 14, True), ("conv6", 256, 512, 1, 5, 7, False),
        ("conv7", 512, 110, 1, 5, 7, False)]
DSL = ("conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,8 pool2=2,2 conv3=3,3,8,8 pool3=3,3 "
       "conv4=1,1,8,6")
H, W = 24, 30


def bits(t):
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def bit_equal(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def unfused(x, kernel, bias, alpha, act_dtype, pooled, padding="SAME"):
    """The layers before the epilogue: conv2d_dense with its bias, leaky,
    the cast to the activation dtype, maxpool_dense."""
    y = tconv.leaky(tconv.conv2d_dense(x, kernel, bias, 1, padding), alpha)
    y = y.to(getattr(torch, act_dtype))
    return tpool.maxpool_dense(y, (2, 2), 2, "VALID") if pooled else y


def pool_first(raw, bias, alpha, act_dtype):
    """The kernel's order: the 2x2 max of the raw conv output, then the
    bias, the activation and the store."""
    v = F.max_pool2d(raw, (2, 2), 2) + bias.reshape(-1, 1, 1)
    v = torch.maximum(v, v * float32_scalar(alpha, "cpu"))
    return v.to(getattr(torch, act_dtype))


def _efcn_case(rng, cin, cout, k, h, w, n=2):
    x = torch.from_numpy(np.abs(rng.randn(n, cin, h, w)).astype(np.float32))
    kernel = torch.from_numpy((rng.randn(cout, cin, k, k) / np.sqrt(cin * k * k))
                              .astype(np.float32))
    bias = torch.from_numpy((rng.randn(cout) * 0.3).astype(np.float32))
    return x, kernel, bias


@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", EFCN, ids=[e[0] for e in EFCN])
def test_the_epilogue_is_the_unfused_sequence_at_each_efcn_layer(rng, layer, act_dtype):
    _, cin, cout, k, h, w, pooled = layer
    x, kernel, bias = _efcn_case(rng, cin, cout, k, h, w)
    want = unfused(x, kernel, bias, 0.1, act_dtype, pooled)
    raw = tconv.conv2d_dense(x, kernel, None, 1, "SAME")
    got = epilogue.conv_epilogue(raw.clone(), bias, 0.1, act_dtype, pooled=pooled)
    assert bit_equal(got, want)
    if pooled:
        assert torch.equal(pool_first(raw, bias, 0.1, act_dtype), want)


@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 3, 7, 9), (1, 4, 9, 8), (5, 5, 5), (2, 2, 3, 6)])
@pytest.mark.parametrize("pooled", [True, False])
def test_odd_sides_pool_by_floor(rng, shape, pooled, act_dtype):
    raw = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    bias = torch.from_numpy(rng.randn(shape[-3]).astype(np.float32))
    y = tconv.leaky(raw + bias.reshape(-1, 1, 1), 0.25).to(getattr(torch, act_dtype))
    want = tpool.maxpool_dense(y, (2, 2), 2, "VALID") if pooled else y
    got = epilogue.conv_epilogue(raw.clone(), bias, 0.25, act_dtype, pooled=pooled)
    assert bit_equal(got, want)
    if pooled:
        assert got.shape[-2:] == (shape[-2] // 2, shape[-1] // 2)
        lead = raw[None] if raw.dim() == 3 else raw
        emulated = pool_first(lead, bias, 0.25, act_dtype)
        assert torch.equal(emulated[0] if raw.dim() == 3 else emulated, want)


@pytest.mark.parametrize("alpha", [1e-30, 0.1, 0.5, 1.0])
def test_pooling_first_is_exact_at_ties_infinities_and_tiny_values(rng, alpha):
    # the values the monotone argument has to survive: ties inside a
    # window, infinities, subnormals, signed zeros, and a bias that
    # rounds the window's values together
    vals = np.array([0.0, -0.0, 1e-45, -1e-45, 1.0, -1.0, 1e8, -1e8, np.inf, -np.inf,
                     3.4e38, -3.4e38, 1.0 + 2**-23, -(1.0 + 2**-23)], np.float32)
    raw = torch.from_numpy(rng.choice(vals, size=(3, 4, 8, 8)))
    bias = torch.from_numpy(np.array([0.0, 1.0, -1e8, 3.4e38], np.float32))
    for act_dtype in ("float32", "bfloat16"):
        want = epilogue.conv_epilogue(raw.clone(), bias, alpha, act_dtype, pooled=True)
        assert torch.equal(pool_first(raw, bias, alpha, act_dtype), want)


def test_a_nan_in_a_window_comes_out_nan(rng):
    raw = torch.from_numpy(rng.randn(2, 3, 6, 8).astype(np.float32))
    raw[0, 1, 2, 5] = float("nan")
    raw[1, 2, 5, 0] = float("nan")
    bias = torch.zeros(3)
    for act_dtype in ("float32", "bfloat16"):
        got = epilogue.conv_epilogue(raw.clone(), bias, 0.1, act_dtype, pooled=True)
        nan = torch.zeros(2, 3, 3, 4, dtype=torch.bool)
        nan[0, 1, 1, 2] = nan[1, 2, 2, 0] = True
        assert torch.equal(got.isnan(), nan)
        assert torch.equal(pool_first(raw, bias, 0.1, act_dtype).isnan(), nan)
        flat = epilogue.conv_epilogue(raw.clone(), bias, 0.1, act_dtype)
        assert torch.equal(flat.isnan(), raw.isnan())


def test_the_wrapper_refuses_what_it_cannot_compute_exactly(rng):
    raw, bias = torch.randn(2, 3, 4, 4), torch.zeros(3)
    for alpha in (0.0, -0.2, 1.5, float("nan")):
        # no pair pools first at such an alpha; the plain version pools
        # after the activation, so it stays the unfused sequence (the
        # kernel refuses to pool there: the chip tests)
        assert not epilogue.pools_exactly(alpha)
        want = tpool.maxpool_dense(tconv.leaky(raw + bias.reshape(-1, 1, 1), alpha),
                                   (2, 2), 2, "VALID")
        assert bit_equal(epilogue.conv_epilogue(raw.clone(), bias, alpha, pooled=True), want)
    with pytest.raises(ValueError, match="bias"):
        epilogue.conv_epilogue(raw, torch.zeros(4), 0.1)
    with pytest.raises(ValueError, match="act_dtype"):
        epilogue.conv_epilogue(raw, bias, 0.1, "float16")


@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pooled", [True, False])
def test_the_kernels_backward_is_the_plain_versions_gradient(rng, monkeypatch, pooled,
                                                             act_dtype):
    # the kernel's autograd function with its launch replaced by the plain
    # version: its backward (a recomputation of the plain version) has to
    # give autograd's gradients of the unfused layers
    monkeypatch.setattr(epilogue, "_launch",
                        lambda x, *args: epilogue.conv_epilogue_plain(x.clone(), *args))
    raw = torch.from_numpy(rng.randn(2, 3, 6, 8).astype(np.float32)).requires_grad_()
    bias = torch.from_numpy(rng.randn(3).astype(np.float32)).requires_grad_()
    up = torch.from_numpy(rng.randn(*((2, 3, 3, 4) if pooled else (2, 3, 6, 8)))
                          .astype(np.float32))
    got = epilogue._Epilogue.apply(raw, bias, 0.1, act_dtype, pooled)
    grads = torch.autograd.grad(got, (raw, bias), up.to(got.dtype))
    want = tconv.leaky(raw + bias.reshape(-1, 1, 1), 0.1).to(getattr(torch, act_dtype))
    want = tpool.maxpool_dense(want, (2, 2), 2, "VALID") if pooled else want
    assert bit_equal(got.detach(), want.detach())
    for g, w in zip(grads, torch.autograd.grad(want, (raw, bias), up.to(want.dtype))):
        assert bit_equal(g, w)
    # a bias alone tracked: only its gradient is computed
    (gb,) = torch.autograd.grad(epilogue._Epilogue.apply(raw.detach(), bias, 0.1, act_dtype,
                                                         pooled), bias, up.to(got.dtype))
    assert bit_equal(gb, grads[1])


def _net(dsl=DSL, act_dtype="float32", alpha=0.1, mode="full", stem_fusion=False):
    return EventNetwork(layers_dict(dsl), H, W, 1e-4, alpha, "SAME", conv_mode=mode,
                        activation_dtype=act_dtype, stem_fusion=stem_fusion)


def _params(net, seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for ld in net.event_layers:
        if ld.kind == "conv":
            cin, (kh, kw), cout = ld.spec.in_shape[0], ld.spec.ksize, ld.spec.out_channels
            out[f"w_{ld.name}"] = torch.randn(cout, cin, kh, kw, generator=g) * 0.3
            out[f"b_{ld.name}"] = torch.randn(cout, generator=g) * 0.1
    return out


def unfused_stack(net, params, frames, upto=None):
    """full_frame_forward's result composed of the unfused layers."""
    x = frames
    for i, ld in enumerate(net.event_layers[1:]):
        if upto is not None and i >= upto:
            return x
        if ld.kind == "conv":
            x = tconv.leaky(tconv.conv2d_dense(x, params[f"w_{ld.name}"], params[f"b_{ld.name}"],
                                               ld.spec.stride, ld.spec.padding), ld.spec.alpha)
        else:
            x = tpool.maxpool_dense(x, ld.spec.ksize, ld.spec.stride, "VALID")
        x = x.to(getattr(torch, ld.spec.act_dtype))
    return x if upto is not None else net.apply_tail(params, x.movedim(-3, -1))


def test_only_full_2x2_stride_2_pools_pair():
    assert _net()._epilogue_pairs == {0, 2}  # pool3 is 3x3
    assert _net(act_dtype="bfloat16")._epilogue_pairs == {0, 2}
    assert _net(mode="sparse_pallas")._epilogue_pairs == frozenset()  # event pools
    assert _net("conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,8@full pool2=2,2",
                mode="dense")._epilogue_pairs == {2}
    assert _net("conv1=3,3,1,4 pool1=4,4 conv2=3,3,4,8 pool2=2,2")._epilogue_pairs == {2}
    for alpha in (0.0, -0.1, 1.5):  # pooling first is exact only for 0 < alpha <= 1
        assert _net(alpha=alpha)._epilogue_pairs == frozenset()


@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
def test_full_frame_forward_is_the_unfused_composition(act_dtype):
    net = _net(act_dtype=act_dtype)
    params = _params(net)
    frames = torch.rand(5, 1, H, W)
    state = net.init_state(params, "cpu")
    tconv.set_matmul_precision("highest")
    got = net.full_frame_forward(params, state, frames)
    assert bit_equal(got, unfused_stack(net, params, frames))
    one = net.full_frame_forward(params, state, frames[3])
    assert bit_equal(one, unfused_stack(net, params, frames[3]))


def test_scan_parallel_with_a_stream_axis_is_the_unfused_composition(rng):
    net = _net()
    params = _params(net, 1)
    s, t, cap = 3, 4, 16
    streams = []
    for k in range(s):
        n = t * cap
        ev = np.stack([rng.randint(0, H, n), rng.randint(0, W, n),
                       np.sort(rng.randint(1, 4000, n)) + 5000 * k], axis=-1).astype(np.int32)
        streams.append(pack_chunks(ev, cap, device="cpu"))
    chunks = EventChunk(*(torch.stack(f) for f in zip(*streams)))
    state = net.init_state(params, "cpu")
    states = tuple(type(st)(*(torch.stack([f] * s) for f in st)) for st in state)
    tconv.set_matmul_precision("highest")
    new_states, outs = net.scan_parallel(params, states, chunks)
    surf, _ = integrate_parallel(states[0].surface, states[0].prev_ts, chunks,
                                 net.event_layers[0].spec.leak)
    want = unfused_stack(net, params, surf.flatten(0, 1)).unflatten(0, (s, t))
    assert bit_equal(outs, want)


@pytest.mark.parametrize("upto,layer", [(1, "conv1"), (3, "conv2"), (2, "pool1")])
def test_an_upto_inside_a_pair_returns_the_conv_map(upto, layer):
    net = _net()
    params = _params(net)
    frames = torch.rand(2, 1, H, W)
    state = net.init_state(params, "cpu")
    got = net.full_frame_forward(params, state, frames, upto=upto)
    assert bit_equal(got, unfused_stack(net, params, frames, upto=upto))
    assert net.event_layers[upto].name == layer


@contextlib.contextmanager
def _spans():
    profiling.clear()
    with profiling.recording():
        yield
    profiling.clear()


def test_the_pair_runs_as_one_epilogue_under_the_conv_span():
    net = _net()
    params = _params(net)
    state = net.init_state(params, "cpu")
    with _spans():
        net.full_frame_forward(params, state, torch.rand(2, 1, H, W))
        spans = profiling.recorded()
    names = [s[0] for s in spans]
    assert "conv.bias" not in names and "layer.pool1" not in names
    assert "layer.pool2" not in names and names.count("layer.pool3") == 1
    assert names.count("pool.max") == 1  # pool3 is 3x3: its own layer
    leaky = [s for s in spans if s[0] == "conv.leaky"]
    assert [spans[s[3]][0] for s in leaky] == [f"layer.conv{k}" for k in (1, 2, 3, 4)]


def test_under_autograd_the_stack_stays_unfused():
    # the gradients stay the unfused layers': the pairs fuse under autograd
    # too (on the card the kernel's backward recomputes the plain version)
    net = _net()
    params = {k: v.requires_grad_() for k, v in _params(net).items()}
    frames = torch.rand(2, 1, H, W)
    state = net.init_state(params, "cpu")
    with _spans():
        out = net.full_frame_forward(params, state, frames)
        names = [s[0] for s in profiling.recorded()]
    assert "conv.bias" not in names and "layer.pool1" not in names
    assert names.count("pool.max") == 1 and names.count("conv.leaky") == 4
    want = unfused_stack(net, params, frames)
    assert bit_equal(out.detach(), want.detach())
    up = torch.rand_like(out)
    got_grads = torch.autograd.grad(out, list(params.values()), up)
    want_grads = torch.autograd.grad(want, list(params.values()), up)
    for g, w in zip(got_grads, want_grads):
        assert g.abs().sum() > 0 and bit_equal(g, w)


def test_a_pair_the_s2d_stem_takes_keeps_its_path(monkeypatch):
    calls = []
    real = epilogue.conv_epilogue

    def spy(x, bias, alpha, act_dtype="float32", pooled=False):
        calls.append(pooled)
        return real(x, bias, alpha, act_dtype, pooled)

    monkeypatch.setattr(epilogue, "conv_epilogue", spy)
    frames = torch.rand(2, 1, H, W)
    outs = {}
    for stem_fusion in (False, True):
        net = _net(stem_fusion=stem_fusion)
        params = _params(net)
        state = net.init_state(params, "cpu")
        calls.clear()
        outs[stem_fusion] = net.full_frame_forward(params, state, frames)
        # conv1 + pool1 is the s2d stem's (a 3x3 SAME conv of one channel)
        assert calls == ([True, False, False] if stem_fusion else [True, True, False, False])
    assert (outs[True] - outs[False]).abs().max() <= 1e-5
