"""On the card: each 'full' network's one-channel stem (conv + bias + leaky
+ 2x2 pool) runs as the fused stem K6 (ops/fused_stem.py,
csrc/fused_stem.cu) inside full_frame_forward, in place of cuDNN's conv
and the pooled epilogue.

K6 rounds each of its nine taps once (an FMA from zero) and adds the bias
after the 2x2 max, as cuDNN's conv and the pooled epilogue round the
library stem (on the H100 the two have agreed bit for bit at every shape
the paths run).  Its pooled map is held within ``K6_TOL * (1 + max|ref|)``
of the unfused library stem (conv2d_dense -> leaky -> maxpool_dense), and
each network's output within 1e-6 of its largest magnitude of the same
network with the stem left to cuDNN and the epilogue (which equals the
unfused layers bit for bit, tests/test_torch_conv_epilogue_chip.py).  The
other pooled 3x3 pairs run as the fused conv + pool C1 on the card where
it gives cuDNN's and the epilogue's numbers bit for bit, and keep them
elsewhere (tests/test_torch_conv_pool_chip.py), so the network's other
side, the CPU's plan, may leave them all to cuDNN and the epilogue.

No JAX here: run it on the card's machine without the tests' conftest:

    python -m pytest --noconftest -p no:cacheprovider -m chip tests/test_torch_stem_route_chip.py
"""

import pytest
import torch

from async_ev_cnn_torch.layers import conv_stack
from async_ev_cnn_torch.layers.network import EventNetwork
from async_ev_cnn_torch.ops import conv_pool as cp
from async_ev_cnn_torch.ops import epilogue
from async_ev_cnn_torch.ops import fused_stem as tf
from async_ev_cnn_torch.ops.conv import conv2d_dense, leaky, set_matmul_precision
from async_ev_cnn_torch.ops.pool import maxpool_dense
from async_ev_cnn_torch.utils.config import layers_dict

EFCN = ("conv1=3,3,1,16 pool1=2,2 conv2=3,3,16,32 pool2=2,2 conv3=3,3,32,64 pool3=2,2 "
        "conv4=3,3,64,128 pool4=2,2 conv5=3,3,128,256 pool5=2,2 conv6=1,1,256,512 "
        "conv7=1,1,512,110")
YOLO_YML = "async_ev_cnn_torch/configs/yolov3_tiny_event.yml"
K6_TOL = tf.K6_TOL
OUT_REL = 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file with pytest --noconftest -m chip there")
    set_matmul_precision("highest")
    yield torch.device("cuda", 0)
    set_matmul_precision("highest")


def _params(net, dev, seed=0, he=False):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for ld in net.event_layers:
        if ld.kind == "conv":
            cin, (kh, kw), cout = ld.spec.in_shape[0], ld.spec.ksize, ld.spec.out_channels
            scale = (2 if he else 1) / (cin * kh * kw)
            out[f"w_{ld.name}"] = (torch.randn(cout, cin, kh, kw, generator=g)
                                   * scale ** 0.5).to(dev)
            out[f"b_{ld.name}"] = (torch.randn(cout, generator=g) * 0.1).to(dev)
    return out


def _frames(n, h, w, dev, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.rand(n, 1, h, w, generator=g, device=dev)
            * (torch.rand(n, 1, h, w, generator=g, device=dev) < 0.2))


def _library_stem(net, params, frames):
    ld = net.event_layers[1]
    return maxpool_dense(leaky(conv2d_dense(frames, params[f"w_{ld.name}"],
                                            params[f"b_{ld.name}"], 1, "SAME"),
                               ld.spec.alpha), (2, 2), 2, "VALID")


def _without_k6(monkeypatch):
    """The walk takes the CPU's plan on the card too: the stem keeps
    cuDNN's conv and the pooled epilogue."""
    real = conv_stack.plan
    monkeypatch.setattr(conv_stack, "plan",
                        lambda net, device=None, grad=False, frames=None: real(net, "cpu", grad))


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _counted(fn):
    tf.reset_launches()
    epilogue.reset_launches()
    cp.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, tf.LAUNCHES["fused_stem"], epilogue.LAUNCHES["conv_epilogue"]


def _check_network(net, params, frames, monkeypatch, want_epilogues, want_c1):
    state = net.init_state(params, frames.device)
    # the card's plan for the batch, made first: its probes launch C1 and E1
    conv_stack.plan(net, frames.device, frames=frames.shape[0])
    stem, k6, e1 = _counted(lambda: net.full_frame_forward(params, state, frames, upto=2))
    assert (k6, e1) == (1, 0)
    lib = _library_stem(net, params, frames)
    assert stem.shape == lib.shape
    assert float((stem - lib).abs().max()) <= K6_TOL * (1 + float(lib.abs().max()))
    got, k6, e1 = _counted(lambda: net.full_frame_forward(params, state, frames))
    # each pooled 3x3 pair runs C1 or, where C1's sums are not cuDNN's at
    # this batch, cuDNN's conv and the epilogue
    assert (k6, e1, cp.LAUNCHES["conv_pool"]) == (1, want_epilogues, want_c1)
    _without_k6(monkeypatch)
    want, k6, e1 = _counted(lambda: net.full_frame_forward(params, state, frames))
    assert (k6, e1, cp.LAUNCHES["conv_pool"]) == (0, want_epilogues + want_c1 + 1, 0)
    for a, b in zip(got if net.heads else (got,), want if net.heads else (want,)):
        assert a.shape == b.shape and _rel(a, b) <= OUT_REL


@pytest.mark.chip
def test_the_efcn_stem_runs_k6_within_its_tolerance_of_the_library_stem(card, monkeypatch):
    net = EventNetwork(layers_dict(EFCN), 160, 224, 5e-5, 0.1, "SAME", conv_mode="full")
    # at 64 frames cuDNN runs conv3 and conv4 as an FFT: they keep it
    _check_network(net, _params(net, card), _frames(64, 160, 224, card), monkeypatch, 4, 2)


@pytest.mark.chip
def test_the_yolov3_tiny_stem_runs_k6_at_416(card, monkeypatch):
    with open(YOLO_YML) as fh:
        text = fh.read().split("yolo_cnn_layers: ")[1].split("\n")[0]
    net = EventNetwork(layers_dict(text), 416, 416, 5e-5, 0.1, "SAME", conv_mode="full",
                       stem_fusion=False)
    # conv0, conv2, conv4 and conv6 pair with their pools; conv8's map is routed
    _check_network(net, _params(net, card, seed=3, he=True), _frames(4, 416, 416, card),
                   monkeypatch, 9, 3)


@pytest.mark.chip
def test_under_autograd_the_stem_keeps_the_epilogue(card):
    net = EventNetwork(layers_dict(EFCN), 160, 224, 5e-5, 0.1, "SAME", conv_mode="full")
    params = _params(net, card)
    tracked = {k: v.clone().requires_grad_() for k, v in params.items()}
    frames = _frames(8, 160, 224, card)
    state = net.init_state(params, card)
    out, k6, e1 = _counted(lambda: net.full_frame_forward(tracked, state, frames))
    assert (k6, e1) == (0, 7) and out.requires_grad
    out.sum().backward()
    assert tracked["w_conv1"].grad is not None
    # grad mode off: the same tracked params take K6, and C1 for conv2-conv5
    # (cuDNN runs none of them as an FFT at 8 frames)
    conv_stack.plan(net, card, frames=8)
    with torch.no_grad():
        _, k6, e1 = _counted(lambda: net.full_frame_forward(tracked, state, frames))
    assert (k6, e1, cp.LAUNCHES["conv_pool"]) == (1, 2, 4)


@pytest.mark.chip
def test_bf16_activations_cast_k6s_pooled_map_once(card):
    net = EventNetwork(layers_dict(EFCN), 160, 224, 5e-5, 0.1, "SAME", conv_mode="full",
                       activation_dtype="bfloat16")
    params = _params(net, card, seed=4)
    frames = _frames(16, 160, 224, card, seed=4)
    got = net.full_frame_forward(params, net.init_state(params, card), frames, upto=2)
    k6 = tf.fused_stem(frames[:, 0].contiguous(), tf.w_taps_from_oihw(params["w_conv1"]),
                       params["b_conv1"], 0.1)
    assert got.dtype == torch.bfloat16 and torch.equal(got, k6.to(torch.bfloat16))


@pytest.mark.chip
def test_a_dispatch_makes_no_copy_of_the_weights_and_waits_for_nothing(card):
    net = EventNetwork(layers_dict(EFCN), 160, 224, 5e-5, 0.1, "SAME", conv_mode="full")
    params = _params(net, card, seed=5)
    frames = _frames(8, 160, 224, card, seed=5)
    state = net.init_state(params, card)
    first = net.full_frame_forward(params, state, frames)  # makes the host weights
    # the stem step of the card's plan, which the network keeps
    weights = next(s.weights for s in conv_stack.plan(net, card, frames=8) if s.route == "stem")
    entry = weights["conv1"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = net.full_frame_forward(params, state, frames)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert weights["conv1"] is entry and torch.equal(first, again)
    params["w_conv1"].mul_(0.5)  # new values in place: the taps are made again
    half = net.full_frame_forward(params, state, frames, upto=2)
    assert weights["conv1"] is not entry
    assert not torch.equal(half, net.full_frame_forward(
        {**params, "w_conv1": params["w_conv1"] * 2}, state, frames, upto=2))


@pytest.mark.chip
def test_k6_on_two_streams_at_once_gives_each_calls_own_result(card):
    """The weights travel with each launch: two calls with other weights on
    two streams at once give what each gives alone."""
    g = torch.Generator(device=card).manual_seed(6)
    x = torch.rand(256, 160, 224, generator=g, device=card)
    weights = [(torch.randn(9, 16, device=card).cpu(), torch.randn(16, device=card).cpu())
               for _ in range(2)]
    alone = [tf.fused_stem(x, w, b, 0.1) for w, b in weights]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(card) for _ in range(2)]
    for _ in range(3):
        outs = []
        for s, (w, b) in zip(streams, weights):
            s.wait_stream(torch.cuda.current_stream(card))
            with torch.cuda.stream(s):
                outs.append(tf.fused_stem(x, w, b, 0.1))
        torch.cuda.synchronize()
        assert all(torch.equal(a, o) for a, o in zip(alone, outs))
