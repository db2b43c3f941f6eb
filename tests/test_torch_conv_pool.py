"""The fused conv + pool C1 (ops/conv_pool.py, csrc/conv_pool.cu) on the
CPU: its plain version against the 'pooled' route's layers within the
derived tolerance, the K-major packing of its weights, the cache that
makes them once per weight tensor, and the wrapper's checks.  The kernel
itself runs on the card only (tests/test_torch_conv_pool_chip.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from async_ev_cnn_torch.ops import conv_pool as cp
from async_ev_cnn_torch.ops import epilogue
from async_ev_cnn_torch.ops.conv import conv2d_dense, set_matmul_precision
from async_ev_cnn_torch.utils import profiling

torch.set_num_threads(2)

SOURCE = Path(cp.__file__).resolve().parent.parent / "csrc" / "conv_pool.cu"

# (id, C_in, C_out, H, W): both models' route pairs at their widths and
# sizes (one frame), and ragged ones (C_in past a chunk, C_out past a tile)
SHAPES = [
    ("efcn_conv2", 16, 32, 80, 112), ("efcn_conv3", 32, 64, 40, 56),
    ("efcn_conv4", 64, 128, 20, 28), ("efcn_conv5", 128, 256, 10, 14),
    ("y3t_conv2", 16, 32, 208, 208), ("y3t_conv4", 32, 64, 104, 104),
    ("y3t_conv6", 64, 128, 52, 52),
    ("ragged_3_5", 3, 5, 6, 10), ("ragged_5_40", 5, 40, 12, 18), ("ragged_1_65", 1, 65, 2, 2),
    ("ragged_9_33", 9, 33, 14, 6),
]


def _operands(c_in, c_out, h, w, n=1, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(n, c_in, h, w, generator=g) * (torch.rand(n, c_in, h, w, generator=g) < 0.4)
    k = torch.randn(c_out, c_in, 3, 3, generator=g) * (2 / (9 * c_in)) ** 0.5
    b = torch.randn(c_out, generator=g) * 0.1
    return x, k, b


def _pooled_route(x, k, b, alpha=0.1):
    """The 'pooled' route's layers: the float32 conv without its bias, then
    the pooled epilogue."""
    return epilogue.conv_epilogue(conv2d_dense(x, k, None, 1, "SAME"), b, alpha, pooled=True)


@pytest.mark.parametrize("c_in,c_out,h,w", [s[1:] for s in SHAPES], ids=[s[0] for s in SHAPES])
def test_the_plain_version_is_the_pooled_routes_layers_within_c1_tol(c_in, c_out, h, w):
    set_matmul_precision("highest")
    x, k, b = _operands(c_in, c_out, h, w, n=2 if h * w < 1000 else 1)
    plain = cp.conv_pool_plain(x, k, b, 0.1)
    route = _pooled_route(x, k, b)
    assert plain.shape == route.shape == (x.shape[0], c_out, h // 2, w // 2)
    assert plain.dtype == torch.float32
    gap = (plain.double() - route.double()).abs()
    assert bool((gap <= cp.c1_bound(x, k, b, plain)).all())


def test_the_bound_is_tight_enough_to_see_one_wrong_weight():
    """A sum that left out one tap of one channel (a kernel indexing the
    wrong weight) falls outside the bound: the bound is the roundings', not
    the terms'."""
    x, k, b = _operands(128, 256, 10, 14, n=2, seed=3)
    plain = cp.conv_pool_plain(x, k, b, 0.1)
    bound = cp.c1_bound(x, k, b, plain)
    wrong = k.clone()
    wrong[7, 100, 1, 2] = 0.0
    off = (cp.conv_pool_plain(x, wrong, b, 0.1).double() - plain.double()).abs()
    assert bool((off > bound).any())
    # at the route's largest K (eFCN conv5, 9 x 128) the bound is about 1e-3
    # of (1 + |out|): first-order worst cases, far from the outputs' size
    assert float((bound / (1 + plain.double().abs())).max()) < 2e-3


def test_pack_weights_lays_the_kernel_out_k_major_and_zero_pads():
    x, k, b = _operands(5, 40, 4, 4)
    packed = cp.pack_weights(k, b)
    assert packed.o_tile == 64 and packed.c_out == 40
    assert packed.w.shape == (8, 9, 64) and packed.bias.shape == (64,)  # C to 8, O to 64
    for c in range(5):
        for dy in range(3):
            for dx in range(3):
                assert torch.equal(packed.w[c, 3 * dy + dx, :40], k[:, c, dy, dx])
    assert not packed.w[5:].any() and not packed.w[:, :, 40:].any()
    assert torch.equal(packed.bias[:40], b) and not packed.bias[40:].any()
    narrow = cp.pack_weights(k[:32], b[:32])
    assert narrow.o_tile == 32 and narrow.w.shape == (8, 9, 32)  # C to 4, O to 32
    assert cp.pack_weights(k[:32, :3], b[:32]).w.shape == (4, 9, 32)
    with pytest.raises(ValueError, match="3, 3"):
        cp.pack_weights(torch.zeros(4, 2, 1, 1), torch.zeros(4))


def test_the_tiles_and_chunk_are_the_kernels():
    src = SOURCE.read_text()
    small, large = re.search(r"kChunk = kOTile == (\d+) \? (\d+) : (\d+);", src).groups()[1:]
    assert cp.CHUNKS == {32: int(small), 64: int(large)}
    assert re.search(r"kChunk = kOTile == 32 \?", src)
    instances = {int(v) for v in re.findall(r"launch<(\d+)>", src)}
    assert instances == set(cp.O_TILES)
    assert re.search(r"o_tile != %d && o_tile != %d" % cp.O_TILES, src)
    assert cp.o_tile(1) == cp.o_tile(32) == 32 and cp.o_tile(33) == cp.o_tile(512) == 64


def test_the_packed_weights_are_made_once_a_weight_tensor():
    _, k, b = _operands(16, 32, 4, 4, seed=9)
    cache = {}
    first = cp.packed_weights(cache, "conv2", k, b)
    assert cp.packed_weights(cache, "conv2", k, b) is first  # found, not made again
    k.mul_(2)  # a write in place bumps the version: made again
    second = cp.packed_weights(cache, "conv2", k, b)
    assert second is not first and torch.equal(second.w, cp.pack_weights(k, b).w)
    assert cp.packed_weights(cache, "conv2", k, b) is second
    b.add_(1)
    assert cp.packed_weights(cache, "conv2", k, b) is not second
    other = k.clone()  # another tensor, equal values: made again
    third = cp.packed_weights(cache, "conv2", other, b)
    assert third is not cp.packed_weights(cache, "conv2", k, b)
    with torch.no_grad():
        k.set_(k.clone())  # new storage under the same tensor: made again
    moved = cp.packed_weights(cache, "conv2", k, b)
    assert cp.packed_weights(cache, "conv2", k, b) is moved
    k.set_(k.clone())
    assert cp.packed_weights(cache, "conv2", k, b) is not moved
    with torch.inference_mode():  # no version to read: made at every call
        k_inf, b_inf = k.clone(), b.clone()
    one = cp.packed_weights(cache, "conv2", k_inf, b_inf)
    assert cp.packed_weights(cache, "conv2", k_inf, b_inf) is not one


def test_the_wrapper_runs_the_plain_version_on_the_cpu_in_its_span():
    x, k, b = _operands(6, 12, 8, 10, n=3, seed=4)
    cp.reset_launches()
    with profiling.recording():
        profiling.clear()
        got = cp.conv_pool(x, k, b, 0.1)
        assert [s[0] for s in profiling.recorded()] == ["conv.fused_pool"]
    assert torch.equal(got, cp.conv_pool_plain(x, k, b, 0.1))
    assert cp.LAUNCHES["conv_pool"] == 0


@pytest.mark.parametrize("case", ["odd_h", "odd_w", "three_dims", "kernel_5x5", "c_in",
                                  "bias", "alpha_0", "alpha_2", "mixed_devices"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    x, k, b = _operands(4, 8, 6, 8)
    args = {"odd_h": (x[:, :, :5], k, b, 0.1), "odd_w": (x[..., :7], k, b, 0.1),
            "three_dims": (x[0], k, b, 0.1),
            "kernel_5x5": (x, torch.zeros(8, 4, 5, 5), b, 0.1),
            "c_in": (x, torch.zeros(8, 3, 3, 3), b, 0.1), "bias": (x, k, b[:7], 0.1),
            "alpha_0": (x, k, b, 0.0), "alpha_2": (x, k, b, 2.0),
            "mixed_devices": (x, torch.empty(8, 4, 3, 3, device="meta"), b, 0.1)}[case]
    with pytest.raises(ValueError):
        cp.conv_pool(*args)


def test_the_plain_version_pools_the_raw_sums_before_the_bias_and_the_activation():
    """max then bias then activation equals the layers' bias, activation,
    max, value for value, on sums rounded once (the pooled epilogue's
    argument), so the plain version is the composition in float64."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.rand(2, 3, 6, 8).astype(np.float32))
    k = torch.from_numpy(rng.randn(4, 3, 3, 3).astype(np.float32))
    b = torch.from_numpy(rng.randn(4).astype(np.float32))
    s = torch.nn.functional.conv2d(x.double(), k.double(), padding=1).float()
    v = s + b.reshape(-1, 1, 1)
    layers = torch.nn.functional.max_pool2d(torch.maximum(v, v * np.float32(0.1)), 2)
    assert torch.equal(cp.conv_pool_plain(x, k, b, 0.1), layers)
