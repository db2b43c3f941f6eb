"""On the card: E1's SiLU form (csrc/conv_epilogue.cu) against ``F.silu``
of the biased conv, the LayerNorm kernel L1 and the LSTM gate kernel G1
against their plain versions, and RVT-B at its published widths and 384x640 input
against the plain reference (reference/rvt.py) over dispatches of carried
LSTM state, whole and in ``window`` slices.

Tolerances: L1, the LayerNorm kernel (csrc/layer_norm.cu), sums each
token's channels in a warp's order where PyTorch's LayerNorm runs
Welford's update, so it is held within ``L1_REL`` (1e-6) of the largest
value of its plain version (``F.layer_norm`` and the partition's copy), in
every layout and partition it takes.  The SiLU form computes ``F.silu``'s
``v / (1 + expf(-v))`` after one rounded bias add, so it is held within
``SILU_REL`` (1e-6) of the largest value, and reads bit-equal on the H100;
G1, the LSTM's gate kernel (csrc/lstm_gates.cu), computes the plain
update's sigmoids and tanhs with the same rounding, within ``G1_REL``
(1e-6).  The network agrees with
the reference to ``REL`` (1e-5) of each level's largest magnitude: batch
norm folded, the LSTM's halves summed apart, cuDNN's and cuBLAS's float32
orders and the attention kernel's (the readings are about 1e-6).

No JAX here: run it on the card's machine without the tests' conftest:

    python -m pytest --noconftest -p no:cacheprovider -m chip tests/test_torch_rvt_chip.py
"""

import pytest
import torch
import torch.nn.functional as F

from async_ev_cnn_torch.layers.network import EventNetwork
from async_ev_cnn_torch.layers.types import EventChunk, LstmState
from async_ev_cnn_torch.ops import epilogue, layer_norm, lstm_gates
from async_ev_cnn_torch.ops.conv import conv2d_dense, set_matmul_precision
from async_ev_cnn_torch.utils.config import layers_dict
from async_ev_cnn_torch.utils.weights import fold_batchnorm
from portbench.reference import efcn as surfaces_ref
from reference import rvt as ref

SILU_REL = 1e-6
L1_REL = 1e-6
G1_REL = 1e-6
REL = 1e-5
H, W = 384, 640
S, T, E = 2, 3, 2000
YAML = "async_ev_cnn_torch/configs/rvt_base_event.yml"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file with pytest --noconftest -m chip there")
    set_matmul_precision("highest")
    yield torch.device("cuda", 0)
    set_matmul_precision("highest")


def rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.chip
@pytest.mark.parametrize("cin, cout, k, hw", [(512, 256, 1, (12, 20)), (128, 128, 3, (48, 80)),
                                              (64, 32, 1, (5, 7))])
def test_the_silu_form_is_silu_of_the_biased_conv(card, cin, cout, k, hw):
    g = torch.Generator(device=card).manual_seed(cin + k)
    x = torch.randn(16, cin, *hw, generator=g, device=card)
    w = torch.randn(cout, cin, k, k, generator=g, device=card) * (2 / (cin * k * k)) ** 0.5
    bias = torch.randn(cout, generator=g, device=card)
    raw = conv2d_dense(x, w, None, 1, "SAME")
    before = dict(epilogue.LAUNCHES)
    got = epilogue.conv_epilogue(raw.clone(), bias, 0.1, act="silu")
    torch.cuda.synchronize()
    assert epilogue.LAUNCHES["conv_epilogue"] == before["conv_epilogue"] + 1
    assert epilogue.LAUNCHES["conv_epilogue_silu"] == before["conv_epilogue_silu"] + 1
    want = F.silu(raw + bias.reshape(-1, 1, 1))
    assert rel(got, want) <= SILU_REL, f"E1's SiLU is {rel(got, want):.3g} from F.silu"


@pytest.mark.chip
@pytest.mark.parametrize("norm", [True, False], ids=["norm", "copy"])
@pytest.mark.parametrize("kind", [None, "win", "grid"])
@pytest.mark.parametrize("layout", ["channels_last", "channels_first"])
@pytest.mark.parametrize("c, hw", [(64, (96, 160)), (512, (12, 20)), (128, (6, 10))])
def test_l1_is_its_plain_version(card, c, hw, layout, kind, norm):
    g = torch.Generator(device=card).manual_seed(c)
    n = 3
    if layout == "channels_last":
        x = torch.randn(n, *hw, c, generator=g, device=card) * 2 + 0.5
    else:  # a conv's NCHW map, read through its permuted view
        x = (torch.randn(n, c, *hw, generator=g, device=card) * 2 + 0.5).permute(0, 2, 3, 1)
    gamma = torch.rand(c, generator=g, device=card) + 0.5 if norm else None
    beta = torch.randn(c, generator=g, device=card) if norm else None
    before = layer_norm.LAUNCHES["layer_norm"]
    got = layer_norm.layer_norm(x, gamma, beta, 1e-5, kind, 6, 10)
    torch.cuda.synchronize()
    assert layer_norm.LAUNCHES["layer_norm"] == before + 1
    want = layer_norm.layer_norm_plain(x, gamma, beta, 1e-5, kind, 6, 10)
    assert got.shape == want.shape and got.is_contiguous()
    if not norm:
        assert torch.equal(got, want), "L1's partition is not the plain copy's"
    assert rel(got, want) <= L1_REL, f"L1 is {rel(got, want):.3g} from its plain version"


@pytest.mark.chip
@pytest.mark.parametrize("rows, c", [(16 * 15360, 64), (16 * 240, 512), (3, 4)])
def test_g1_is_its_plain_version(card, rows, c):
    g = torch.Generator(device=card).manual_seed(c)
    gates = torch.randn(rows, 4 * c, generator=g, device=card) * 3
    cell = torch.randn(rows, c, generator=g, device=card) * 2
    want_c, want_h = cell.clone(), torch.empty_like(cell)
    lstm_gates.lstm_gates_plain(gates.clone(), want_c, want_h)
    h = torch.empty_like(cell)
    before = lstm_gates.LAUNCHES["lstm_gates"]
    lstm_gates.lstm_gates(gates, cell, h)
    torch.cuda.synchronize()
    assert lstm_gates.LAUNCHES["lstm_gates"] == before + 1
    assert rel(cell, want_c) <= G1_REL and rel(h, want_h) <= G1_REL, (
        f"G1 is {rel(cell, want_c):.3g} (cell), {rel(h, want_h):.3g} (hidden) from its plain "
        "version")


def _dispatches(card, n):
    g = torch.Generator(device=card).manual_seed(7)
    chain = surfaces_ref.SurfaceChain(S, H, W, 5e-5, card)
    for d in range(n):
        y = torch.randint(0, H, (S, T, E), generator=g, device=card)
        x = torch.randint(0, W, (S, T, E), generator=g, device=card)
        ts = (torch.arange(T * E, device=card).reshape(1, T, E).expand(S, T, E) + d * T * E) * 5
        valid = torch.ones(S, T, E, dtype=torch.bool, device=card)
        yield (EventChunk(y.int(), x.int(), ts.int(), torch.zeros_like(y).int(), valid),
               chain.run(y, x, ts, valid, range(T)))


@pytest.mark.chip
@pytest.mark.parametrize("window", [None, 2])
def test_rvt_b_is_the_reference_over_carried_state(card, window):
    text = open(YAML).read().split("yolo_cnn_layers: ")[1].split("\n")[0]
    net = EventNetwork(layers_dict(text), H, W, 5e-5, 0.1, "SAME", conv_mode="full",
                       stem_fusion=False)
    arch = ref.architecture()
    wt = ref.make_weights(arch, 2024, card)
    params = fold_batchnorm(wt, eps=ref.BN_EPS, form="torch")
    st = tuple(type(s)(*(f.expand(S, *f.shape).clone() for f in s))
               for s in net.init_state(params, card))
    carry = None
    net.reset_counts()
    with torch.no_grad():
        for d, (chunks, surfaces) in enumerate(_dispatches(card, 2)):
            st, outs = net.scan_parallel(params, st, chunks, window=window)
            want, carry = ref.forward(wt, arch, surfaces[:, :, None], carry)
            for level, (a, b) in enumerate(zip(outs, want)):
                assert rel(a, b) <= REL, (
                    f"dispatch {d}, level {level}: {rel(a, b):.3g} from the reference")
    assert sum(c["recurrent_steps"] for c in net.layer_counts.values()) == 2 * 4 * T
    lstm = [s for s in st if isinstance(s, LstmState)]
    for (h, c), s in zip(carry, lstm):
        assert rel(s.h, h) <= REL and rel(s.c, c) <= REL, "the carried (h, c) drifted"
