"""On the card: the conv epilogue kernel (csrc/conv_epilogue.cu) at
YOLOv3-tiny's shapes, and one forward of the published network against the
plain reference (reference/yolov3_tiny.py).

The linear heads (conv15, conv22) run the kernel at alpha = 1, where the
activation is the identity: bit-equal to the bias added alone.  conv8's
output feeds the skip route, so it runs the unpooled kernel and pool9
after it, which is bit-equal to the pooled kernel (the pool commutes with
a nondecreasing activation).  The forward agrees with the reference to the
batch-norm folding's rounding (tests/test_torch_yolov3_tiny.py).

No JAX here: run it on the card's machine without the tests' conftest:

    python -m pytest --noconftest -p no:cacheprovider -m chip tests/test_torch_yolov3_tiny_chip.py
"""

import pytest
import torch

from async_ev_cnn_torch.layers import conv_stack
from async_ev_cnn_torch.layers.network import EventNetwork
from async_ev_cnn_torch.ops import conv_pool, epilogue, fused_stem
from async_ev_cnn_torch.ops.conv import set_matmul_precision
from async_ev_cnn_torch.ops.pool import maxpool_dense
from async_ev_cnn_torch.utils.config import layers_dict
from async_ev_cnn_torch.utils.weights import fold_batchnorm
from reference import yolov3_tiny as ref

N = 64


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file with pytest --noconftest -m chip there")
    set_matmul_precision("highest")
    yield torch.device("cuda", 0)
    set_matmul_precision("highest")


@pytest.mark.chip
@pytest.mark.parametrize("shape", [(255, 13, 13), (255, 26, 26)], ids=["conv15", "conv22"])
def test_the_kernel_at_alpha_one_is_the_bias_alone(card, shape):
    g = torch.Generator(device=card).manual_seed(shape[1])
    raw = torch.randn(N, *shape, generator=g, device=card) * 4
    bias = torch.randn(shape[0], generator=g, device=card)
    before = epilogue.LAUNCHES["conv_epilogue"]
    got = epilogue.conv_epilogue(raw, bias, 1.0)
    torch.cuda.synchronize()
    assert epilogue.LAUNCHES["conv_epilogue"] == before + 1
    assert torch.equal(got, raw + bias.reshape(-1, 1, 1))
    assert torch.equal(got, epilogue.conv_epilogue_plain(raw.clone(), bias, 1.0))


@pytest.mark.chip
def test_conv8_unpooled_then_pool9_is_the_pooled_kernel(card):
    g = torch.Generator(device=card).manual_seed(8)
    raw = torch.randn(N, 256, 26, 26, generator=g, device=card)
    bias = torch.randn(256, generator=g, device=card) * 0.3
    skip = epilogue.conv_epilogue(raw, bias, 0.1)
    got = maxpool_dense(skip, (2, 2), 2, "VALID")
    assert torch.equal(skip, epilogue.conv_epilogue_plain(raw.clone(), bias, 0.1))
    assert torch.equal(got, epilogue.conv_epilogue(raw, bias, 0.1, pooled=True))


@pytest.mark.chip
def test_one_forward_of_the_published_network_is_the_reference(card):
    layers = ref.darknet_layers()
    text = open("async_ev_cnn_torch/configs/yolov3_tiny_event.yml").read().split(
        "yolo_cnn_layers: ")[1].split("\n")[0]
    net = EventNetwork(layers_dict(text), 416, 416, 5e-5, 0.1, "SAME", conv_mode="full",
                       stem_fusion=False)
    g = torch.Generator(device=card).manual_seed(3)
    w = {}
    for i, layer in enumerate(layers):
        if layer["kind"] != "conv":
            continue
        k, cin, cout = layer["size"], layer["in"], layer["filters"]
        w[f"w_conv{i}"] = torch.randn(cout, cin, k, k, generator=g, device=card) * (
            2 / (cin * k * k)) ** 0.5
        stats = ("gamma", "var", "beta", "mean") if layer["bn"] else ("b",)
        for stat in stats:
            w[f"{stat}_conv{i}"] = (torch.rand(cout, generator=g, device=card) + 0.5
                                    if stat in ("gamma", "var")
                                    else torch.randn(cout, generator=g, device=card) * 0.1)
    params = fold_batchnorm(w)
    frames = torch.rand(4, 1, 416, 416, generator=g, device=card) * (
        torch.rand(4, 1, 416, 416, generator=g, device=card) < 0.1)
    conv_stack.plan(net, card, frames=4)  # made first: its probes launch C1 and E1
    before = epilogue.LAUNCHES["conv_epilogue"]
    stems = fused_stem.LAUNCHES["fused_stem"]
    fused = conv_pool.LAUNCHES["conv_pool"]
    got = net.full_frame_forward(params, net.init_state(params, card), frames)
    torch.cuda.synchronize()
    # the fused stem K6 (conv0 -> pool1), the fused conv + pool C1 (conv2/4/6
    # and their pools: cuDNN's implicit GEMMs at this batch, whose numbers
    # C1 gives) and nine unpooled epilogues
    assert fused_stem.LAUNCHES["fused_stem"] - stems == 1
    assert conv_pool.LAUNCHES["conv_pool"] - fused == 3
    assert epilogue.LAUNCHES["conv_epilogue"] - before == 9
    want = ref.forward(frames, w, layers)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max() / b.abs().max()) < 1e-5
