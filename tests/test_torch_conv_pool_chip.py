"""On the card: each 'full' network's 2x2-pooled 3x3 convs other than the
stem (the eFCN's conv2-conv5, YOLOv3-tiny's conv2, conv4 and conv6) take
the 'conv_pool' route inside full_frame_forward: the fused conv + pool C1
(ops/conv_pool.py, csrc/conv_pool.cu) in place of cuDNN's conv and the
pooled epilogue wherever C1 gives their numbers bit for bit at the batch
(the card's plan for the batch probes each pair once,
layers/conv_stack.c1_gives_the_library; the pairs cuDNN runs as an FFT
keep cuDNN, and which they are at each batch is asserted here).

C1 sums each output's 9 x C_in products by FMA in cuDNN's implicit-GEMM
order, so it is held within its derived bound of its plain version
(``c1_bound``: the conv summed in float64) and within 1e-6 of the largest
magnitude of cuDNN's conv and the pooled epilogue at the route's seven
shapes, and each network's output is the same network's on the 'pooled'
route, bit for bit.

No JAX here: run it on the card's machine without the tests' conftest:

    python -m pytest --noconftest -p no:cacheprovider -m chip tests/test_torch_conv_pool_chip.py
"""

import pytest
import torch

from async_ev_cnn_torch.layers import conv_stack
from async_ev_cnn_torch.layers.network import EventNetwork
from async_ev_cnn_torch.ops import conv_pool as cp
from async_ev_cnn_torch.ops import epilogue
from async_ev_cnn_torch.ops import fused_stem as tf
from async_ev_cnn_torch.ops.conv import conv2d_dense, set_matmul_precision
from async_ev_cnn_torch.utils.config import layers_dict

EFCN = ("conv1=3,3,1,16 pool1=2,2 conv2=3,3,16,32 pool2=2,2 conv3=3,3,32,64 pool3=2,2 "
        "conv4=3,3,64,128 pool4=2,2 conv5=3,3,128,256 pool5=2,2 conv6=1,1,256,512 "
        "conv7=1,1,512,110")
YOLO_YML = "async_ev_cnn_torch/configs/yolov3_tiny_event.yml"
LIB_REL = cp.LIBRARY_REL

# the pairs that run C1 at a batch on the H100, in PyTorch's cuDNN: the
# others cuDNN runs as an FFT there, so they keep the 'pooled' route
C1_AT = {
    ("efcn", 1): ("conv2", "conv3", "conv4", "conv5"),
    ("efcn", 4): ("conv2", "conv3", "conv4", "conv5"),
    ("efcn", 8): ("conv2", "conv3", "conv4", "conv5"),
    ("efcn", 16): ("conv2", "conv4", "conv5"),
    ("efcn", 64): ("conv2", "conv5"),
    ("efcn", 200): ("conv2", "conv4", "conv5"),
    ("efcn", 1024): ("conv2", "conv4", "conv5"),
    ("yolov3_tiny", 4): ("conv2", "conv4", "conv6"),
    ("yolov3_tiny", 16): ("conv2", "conv4"),
    ("yolov3_tiny", 64): ("conv2", "conv4", "conv6"),
    ("yolov3_tiny", 1024): ("conv2", "conv4", "conv6"),
}

# (id, C_in, C_out, H, W): the route's seven pairs
SHAPES = [
    ("efcn_conv2", 16, 32, 80, 112), ("efcn_conv3", 32, 64, 40, 56),
    ("efcn_conv4", 64, 128, 20, 28), ("efcn_conv5", 128, 256, 10, 14),
    ("y3t_conv2", 16, 32, 208, 208), ("y3t_conv4", 32, 64, 104, 104),
    ("y3t_conv6", 64, 128, 52, 52),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file with pytest --noconftest -m chip there")
    set_matmul_precision("highest")
    yield torch.device("cuda", 0)
    set_matmul_precision("highest")
    torch.cuda.empty_cache()


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _operands(n, c_in, c_out, h, w, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(n, c_in, h, w, generator=g, device=dev) * (
        torch.rand(n, c_in, h, w, generator=g, device=dev) < 0.5)
    k = torch.randn(c_out, c_in, 3, 3, generator=g, device=dev) * (2 / (9 * c_in)) ** 0.5
    b = torch.randn(c_out, generator=g, device=dev) * 0.1
    return x, k, b


@pytest.mark.chip
@pytest.mark.parametrize("n", [1024, 64, 1])
@pytest.mark.parametrize("c_in,c_out,h,w", [s[1:] for s in SHAPES], ids=[s[0] for s in SHAPES])
def test_c1_is_within_its_bound_of_the_plain_version_and_close_to_the_library(
        card, n, c_in, c_out, h, w):
    x, k, b = _operands(n, c_in, c_out, h, w, card, seed=n + c_in)
    cp.reset_launches()
    got = cp.conv_pool(x, k, b, 0.1)
    again = cp.conv_pool(x, k, b, 0.1, cp.pack_weights(k, b))
    torch.cuda.synchronize()
    assert cp.LAUNCHES["conv_pool"] == 2 and torch.equal(got, again)  # deterministic
    assert got.shape == (n, c_out, h // 2, w // 2)
    plain = cp.conv_pool_plain(x, k, b, 0.1)
    assert bool(((got.double() - plain.double()).abs() <= cp.c1_bound(x, k, b, plain)).all())
    del plain
    lib = epilogue.conv_epilogue(conv2d_dense(x, k, None, 1, "SAME"), b, 0.1, pooled=True)
    assert _rel(got, lib) <= LIB_REL


def _efcn(dev, n=64):
    net = EventNetwork(layers_dict(EFCN), 160, 224, 5e-5, 0.1, "SAME", conv_mode="full")
    return net, _params(net, dev), _frames(n, 160, 224, dev)


def _yolo(dev, n=4):
    with open(YOLO_YML) as fh:
        text = fh.read().split("yolo_cnn_layers: ")[1].split("\n")[0]
    net = EventNetwork(layers_dict(text), 416, 416, 5e-5, 0.1, "SAME", conv_mode="full",
                       stem_fusion=False)
    return net, _params(net, dev, seed=3, he=True), _frames(n, 416, 416, dev)


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


def _counted(fn):
    cp.reset_launches()
    tf.reset_launches()
    epilogue.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, (cp.LAUNCHES["conv_pool"], tf.LAUNCHES["fused_stem"],
                 epilogue.LAUNCHES["conv_epilogue"])


def _c1(net, dev, n):
    """The convs whose pairs run C1 in the card's plan for ``n`` frames."""
    return tuple(s.layers[0].name for s in conv_stack.plan(net, dev, frames=n)
                 if s.route == "conv_pool")


def _without_c1(monkeypatch):
    """The card's plan with every 'conv_pool' pair back on the 'pooled'
    route: cuDNN's conv and the pooled epilogue."""
    real = conv_stack.plan

    def plan(net, device=None, grad=False, frames=None):
        return tuple(s._replace(route="pooled", weights=None) if s.route == "conv_pool" else s
                     for s in real(net, device, grad, frames))

    monkeypatch.setattr(conv_stack, "plan", plan)


@pytest.mark.chip
@pytest.mark.parametrize("model,n", list(C1_AT), ids=[f"{m}-{n}" for m, n in C1_AT])
def test_the_card_plan_runs_c1_where_cudnn_runs_an_implicit_gemm(card, model, n):
    """The plan probes each pair once for the batch, and counts the
    probe's launches: one C1 and one pooled epilogue a pair."""
    net, _, _ = _efcn(card, 1) if model == "efcn" else _yolo(card, 1)
    pairs = 4 if model == "efcn" else 3
    _, counts = _counted(lambda: _c1(net, card, n))
    assert _c1(net, card, n) == C1_AT[model, n]
    assert counts == (pairs, 0, pairs)


@pytest.mark.chip
@pytest.mark.parametrize("model,pairs,lone", [("efcn", 4, 2), ("yolov3_tiny", 3, 9)])
@pytest.mark.parametrize("n", [64, 4])
def test_a_forward_runs_c1_on_the_pooled_3x3_pairs_and_gives_the_pooled_routes_output(
        card, monkeypatch, model, pairs, lone, n):
    net, params, frames = _efcn(card, n) if model == "efcn" else _yolo(card, n)
    state = net.init_state(params, card)
    c1 = len(_c1(net, card, n))  # the plan for the batch, made (and probed) first
    assert c1 == len(C1_AT[model, n])
    got, counts = _counted(lambda: net.full_frame_forward(params, state, frames))
    assert counts == (c1, 1, lone + pairs - c1)  # C1, K6, E1
    _without_c1(monkeypatch)
    want, counts = _counted(lambda: net.full_frame_forward(params, state, frames))
    assert counts == (0, 1, lone + pairs)
    for a, b in zip(got if net.heads else (got,), want if net.heads else (want,)):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.chip
def test_under_autograd_or_in_bf16_the_pairs_keep_the_epilogue(card):
    net, params, frames = _efcn(card, n=8)
    tracked = {k: v.clone().requires_grad_() for k, v in params.items()}
    state = net.init_state(params, card)
    out, counts = _counted(lambda: net.full_frame_forward(tracked, state, frames))
    assert counts == (0, 0, 7) and out.requires_grad
    out.sum().backward()
    assert tracked["w_conv3"].grad is not None
    c1 = len(C1_AT["efcn", 8])
    assert len(_c1(net, card, 8)) == c1
    with torch.no_grad():  # grad mode off: the same tracked params take C1
        _, counts = _counted(lambda: net.full_frame_forward(tracked, state, frames))
    assert counts == (c1, 1, 6 - c1)
    bf16 = EventNetwork(layers_dict(EFCN), 160, 224, 5e-5, 0.1, "SAME", conv_mode="full",
                        activation_dtype="bfloat16")
    _, counts = _counted(lambda: bf16.full_frame_forward(params, state, frames))
    assert counts == (0, 1, 6)


@pytest.mark.chip
def test_a_dispatch_packs_no_weights_and_waits_for_nothing(card):
    net, params, frames = _efcn(card, n=8)
    state = net.init_state(params, card)
    first = net.full_frame_forward(params, state, frames)  # packs the weights
    steps = [s for s in conv_stack.plan(net, card, frames=8) if s.route == "conv_pool"]
    assert [s.layers[0].name for s in steps] == ["conv2", "conv3", "conv4", "conv5"]
    entries = [s.weights[s.layers[0].name] for s in steps]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = net.full_frame_forward(params, state, frames)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(first, again)
    assert all(s.weights[s.layers[0].name] is e for s, e in zip(steps, entries))
    assert _c1(net, card, 8) == C1_AT["efcn", 8]
    with torch.no_grad():
        params["w_conv2"].mul_(0.5)  # new values in place: packed again
    net.full_frame_forward(params, state, frames)
    assert steps[0].weights["conv2"] is not entries[0]
    assert steps[3].weights["conv5"] is entries[3]
