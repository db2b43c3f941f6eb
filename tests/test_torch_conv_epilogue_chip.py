"""On the card: the conv epilogue kernel (csrc/conv_epilogue.cu) against its
plain version at the eFCN's seven conv outputs, its launches on the
parallel path, and a served dispatch against the unfused layers.

The kernel pools the raw conv output before the bias and the activation,
which is exact for 0 < alpha <= 1 (ops/epilogue.py), so each comparison of
the kernel is ``torch.equal``: value for value, a zero's sign aside.  On
the parallel path conv1 -> pool1 runs as the fused stem K6 instead
(tests/test_torch_stem_route_chip.py), which rounds as cuDNN's conv and
the pooled epilogue do, so a served dispatch is still the unfused layers'
output value for value.

No JAX here: the card's machine has none, so run it there without the
tests' conftest:

    python -m pytest --noconftest -p no:cacheprovider -m chip tests/test_torch_conv_epilogue_chip.py
"""

import numpy as np
import pytest
import torch

from async_ev_cnn_torch.layers import conv_stack
from async_ev_cnn_torch.layers.network import EventNetwork
from async_ev_cnn_torch.ops import epilogue, fused_stem
from async_ev_cnn_torch.ops.conv import set_matmul_precision
from async_ev_cnn_torch.utils.config import layers_dict

H, W = 160, 224
EFCN = ("conv1=3,3,1,16 pool1=2,2 conv2=3,3,16,32 pool2=2,2 conv3=3,3,32,64 pool3=2,2 "
        "conv4=3,3,64,128 pool4=2,2 conv5=3,3,128,256 pool5=2,2 conv6=1,1,256,512 "
        "conv7=1,1,512,110")
# the eFCN's conv outputs: (C, H, W, pooled)
SHAPES = [(16, 160, 224, True), (32, 80, 112, True), (64, 40, 56, True),
          (128, 20, 28, True), (256, 10, 14, True), (512, 5, 7, False), (110, 5, 7, False)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file with pytest --noconftest -m chip there")
    set_matmul_precision("highest")
    yield torch.device("cuda", 0)
    set_matmul_precision("highest")


def _params(net, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for ld in net.event_layers:
        if ld.kind == "conv":
            cin, (kh, kw), cout = ld.spec.in_shape[0], ld.spec.ksize, ld.spec.out_channels
            out[f"w_{ld.name}"] = (torch.randn(cout, cin, kh, kw, generator=g)
                                   / (cin * kh * kw) ** 0.5).to(dev)
            out[f"b_{ld.name}"] = (torch.randn(cout, generator=g) * 0.1).to(dev)
    return out


@pytest.mark.chip
@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"conv{k + 1}" for k in range(7)])
def test_the_kernel_is_its_plain_version_at_each_efcn_shape(card, shape, act_dtype):
    c, h, w, pooled = shape
    g = torch.Generator(device=card).manual_seed(c)
    raw = torch.randn(64, c, h, w, generator=g, device=card)
    bias = torch.randn(c, generator=g, device=card) * 0.3
    before = epilogue.LAUNCHES["conv_epilogue"]
    got = epilogue.conv_epilogue(raw, bias, 0.1, act_dtype, pooled=pooled)
    want = epilogue.conv_epilogue_plain(raw.clone(), bias, 0.1, act_dtype, pooled=pooled)
    torch.cuda.synchronize()
    assert epilogue.LAUNCHES["conv_epilogue"] == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.chip
def test_one_forward_of_the_efcn_launches_k6_and_six_epilogues_and_a_step_none(card):
    from async_ev_cnn_torch.layers.types import EventChunk
    from async_ev_cnn_torch.models.yolo import YoloEventTorch

    net = EventNetwork(layers_dict(EFCN), H, W, 5e-5, 0.1, "SAME", conv_mode="full")
    params = _params(net, card)
    state = net.init_state(params, card)
    frames = torch.rand(8, 1, H, W, device=card)
    before = epilogue.LAUNCHES["conv_epilogue"]
    stems = fused_stem.LAUNCHES["fused_stem"]
    net.full_frame_forward(params, state, frames)
    torch.cuda.synchronize()
    # conv1 -> pool1 runs as the fused stem K6; conv2..conv7 take the epilogue
    assert epilogue.LAUNCHES["conv_epilogue"] - before == 6
    assert fused_stem.LAUNCHES["fused_stem"] - stems == 1
    # params that track gradients take the kernel too, after each of the
    # seven convs: K6 has no backward
    tracked = {k: v.clone().requires_grad_() for k, v in params.items()}
    before = epilogue.LAUNCHES["conv_epilogue"]
    stems = fused_stem.LAUNCHES["fused_stem"]
    out = net.full_frame_forward(tracked, state, frames)
    torch.cuda.synchronize()
    assert epilogue.LAUNCHES["conv_epilogue"] - before == 7 and out.requires_grad
    assert fused_stem.LAUNCHES["fused_stem"] == stems

    model = YoloEventTorch(h_frame=H, w_frame=W, num_classes=100, cnn_layers=layers_dict(EFCN),
                           cnn_padding="SAME", h_cells=5, w_cells=7, num_bbox=2, alpha=0.1,
                           leak=5e-5, conv_mode="sparse_pallas", device=card)
    model.params.update(_params(model.net, card))
    st = model.init_state()
    rng = np.random.RandomState(0)
    chunk = EventChunk.from_arrays(rng.randint(0, H, 200), rng.randint(0, W, 200),
                                   np.sort(rng.randint(1, 1000, 200)), capacity=256,
                                   device=card)
    before = epilogue.LAUNCHES["conv_epilogue"]
    model.step(st, chunk)
    torch.cuda.synchronize()
    assert epilogue.LAUNCHES["conv_epilogue"] == before


@pytest.mark.chip
def test_a_served_dispatch_is_the_unfused_layers_output(card, monkeypatch):
    from async_ev_cnn_torch.utils.serving import StreamingPipeline

    net = EventNetwork(layers_dict(EFCN), H, W, 5e-5, 0.1, "SAME", conv_mode="full")
    params = _params(net, card, 1)
    rng = np.random.RandomState(1)
    items = []
    for k in range(4):
        n = 8 * 200
        items.append(np.stack([rng.randint(0, H, n), rng.randint(0, W, n),
                               np.sort(rng.randint(1, 20 * n, n)) + 40 * n * k],
                              axis=-1).astype(np.int32))

    def serve():
        pipe = StreamingPipeline(net, params, capacity=256, streams=2, t_chunks=8,
                                 device=card)
        return [r.outputs for r in pipe.serve(items)], pipe.state

    before = epilogue.LAUNCHES["conv_epilogue"]
    stems = fused_stem.LAUNCHES["fused_stem"]
    fused, fused_state = serve()
    # two dispatches: the fused stem K6 and six epilogues each
    assert epilogue.LAUNCHES["conv_epilogue"] - before >= 2 * 6
    assert fused_stem.LAUNCHES["fused_stem"] - stems >= 2
    monkeypatch.setattr(epilogue, "conv_epilogue", epilogue.conv_epilogue_plain)
    real = conv_stack.plan  # the CPU's plan: conv1 and pool1 unfused too
    monkeypatch.setattr(conv_stack, "plan",
                        lambda net, device=None, grad=False: real(net, "cpu", grad))
    plain, plain_state = serve()
    assert len(fused) == len(plain) == 2
    for a, b in zip(fused, plain):
        assert torch.equal(a, b)
    for a, b in zip(fused_state, plain_state):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.chip
@pytest.mark.parametrize("pooled", [True, False])
def test_a_tensor_past_two_to_the_31_elements_is_one_launch(card, pooled):
    # 2,181,038,080 elements (8.7 GB): the offsets into it pass 32 bits
    c, h, w = 16, 1024, 1024
    raw = torch.randn(130, c, h, w, device=card)
    bias = torch.randn(c, device=card)
    before = epilogue.LAUNCHES["conv_epilogue"]
    got = epilogue.conv_epilogue(raw, bias, 0.1, pooled=pooled)
    torch.cuda.synchronize()
    assert epilogue.LAUNCHES["conv_epilogue"] - before == 1
    assert torch.equal(got, epilogue.conv_epilogue_plain(raw, bias, 0.1, pooled=pooled))


@pytest.mark.chip
@pytest.mark.parametrize("pooled", [True, False])
def test_gradients_through_the_kernel_are_the_unfused_layers(card, pooled):
    from async_ev_cnn_torch.ops import conv as tconv
    from async_ev_cnn_torch.ops import pool as tpool

    g = torch.Generator(device=card).manual_seed(7)
    raw = torch.randn(8, 32, 80, 112, generator=g, device=card).requires_grad_()
    bias = (torch.randn(32, generator=g, device=card) * 0.3).requires_grad_()
    before = epilogue.LAUNCHES["conv_epilogue"]
    got = epilogue.conv_epilogue(raw, bias, 0.1, pooled=pooled)
    assert epilogue.LAUNCHES["conv_epilogue"] == before + 1 and got.requires_grad
    want = tconv.leaky(raw + bias.reshape(-1, 1, 1), 0.1)
    want = tpool.maxpool_dense(want, (2, 2), 2, "VALID") if pooled else want
    assert torch.equal(got, want)
    up = torch.randn(got.shape, generator=g, device=card)
    for a, b in zip(torch.autograd.grad(got, (raw, bias), up),
                    torch.autograd.grad(want, (raw, bias), up)):
        assert torch.equal(a, b)


@pytest.mark.chip
def test_the_kernel_refuses_to_pool_where_pooling_first_is_not_exact(card):
    raw, bias = torch.randn(2, 3, 8, 8, device=card), torch.zeros(3, device=card)
    for alpha in (0.0, -0.2, 1.5):
        with pytest.raises(RuntimeError, match="conv_epilogue kernel launch failed"):
            epilogue.conv_epilogue(raw, bias, alpha, pooled=True)
        got = epilogue.conv_epilogue(raw, bias, alpha)  # unpooled: any alpha
        assert torch.equal(got, epilogue.conv_epilogue_plain(raw.clone(), bias, alpha))
