"""The port's matmul tiers and bf16 activation storage, mirroring
tests/test_act_dtype.py, and held against the JAX package.

On the CPU the tier changes no number in either package (the JAX CPU
backend ignores ``Precision``; the port applies its TF32 flags to the card
only), so port against JAX compares at float32 tolerances at every tier:
1e-4 absolute for conv stacks (the contract of tests/test_equivalence.py).
bf16 storage quantises the activated maps; where two runs round a float32
conv output that differs in the last bits, one bf16 step (2^-8 relative)
can separate them, so those comparisons are within 2e-2 of the output
scale, the bound tests/test_act_dtype.py uses.  A bf16 cast of the same
float32 values is bit for bit in both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from async_ev_cnn_torch.layers import network as tnet
from async_ev_cnn_torch.ops import conv as tconv
from async_ev_cnn_torch.utils.equivalence import make_stream as tmake
from async_ev_cnn_torch.utils.equivalence import run_equivalence as trun
from async_ev_cnn_torch.utils.weights import params_from_jax
from async_ev_cnn_tpu.layers import network as jnet
from async_ev_cnn_tpu.ops import conv as jconv
from async_ev_cnn_tpu.utils.config import layers_dict
from async_ev_cnn_tpu.utils.equivalence import make_stream as jmake

torch.set_num_threads(2)
H = W = 16
DSL = "conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,8 pool2=2,2 conv3=1,1,8,12"
TIERS = ("highest", "high", "default")
TOL = 1e-4


def _params(rng):
    out = {}
    for name, size in layers_dict(DSL).items():
        if "conv" in name:
            out[f"w_{name}"] = (rng.randn(*size[:2], size[2], size[3]) * 0.2).astype(np.float32)
            out[f"b_{name}"] = (rng.randn(size[3]) * 0.1).astype(np.float32)
    return out


def _net(act, mode="full", pkg=tnet, **kw):
    return pkg.EventNetwork(layers_dict(DSL), H, W, leak=1e-4, alpha=0.1, padding="SAME",
                            conv_mode=mode, activation_dtype=act, **kw)


def _stream(seed, steps):
    return (tmake(np.random.RandomState(seed), steps, 20, H, W, device="cpu"),
            jmake(np.random.RandomState(seed), steps, 20, H, W))


def _scan_parallel(net, params, chunks):
    return net.scan_parallel(params, net.init_state(params, "cpu"), chunks)


def _set_tier(tier):
    tconv.set_matmul_precision(tier)
    jconv.set_matmul_precision(tier)


@pytest.fixture(autouse=True)
def _highest_after():
    yield
    _set_tier("highest")


@pytest.mark.parametrize("tier", TIERS)
def test_tier_sets_the_library_flags(tier):
    """'default' is TF32 in cuDNN and cuBLAS; 'highest' and 'high' are IEEE
    float32 (both flags off)."""
    torch.backends.cudnn.allow_tf32 = tier != "default"
    tconv.set_matmul_precision(tier)
    assert tconv.matmul_precision() == tier
    tf32 = tier == "default"
    assert tconv.tier_uses_tf32() is tf32
    assert torch.backends.cudnn.allow_tf32 is tf32
    assert torch.backends.cuda.matmul.allow_tf32 is tf32
    tconv.set_matmul_precision("highest")
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    with pytest.raises(ValueError, match="one of"):
        tconv.set_matmul_precision("fast")


def test_round_tf32_is_cvt_rna():
    """Round to 10 mantissa bits, to nearest, ties away from zero, against
    a float64 reference; TF32 values are fixed points; the CPU operands of
    the gather-GEMM plain versions stay float32 at every tier."""
    rng = np.random.RandomState(5)
    x = np.concatenate([rng.randn(2000).astype(np.float32) * 10.0 ** rng.randint(-5, 5, 2000),
                        np.array([1 + 2**-11, -(1 + 2**-11), 1 + 3 * 2**-11, 0.0, -0.0,
                                  1 - 2**-12], np.float32)]).astype(np.float32)
    got = tconv.round_tf32(torch.from_numpy(x)).numpy()
    m, e = np.frexp(x.astype(np.float64))           # x = m * 2**e, 0.5 <= |m| < 1
    want = np.sign(m) * np.floor(np.abs(m) * 2**11 + 0.5) / 2**11 * 2.0**e
    np.testing.assert_array_equal(got, want.astype(np.float32))
    np.testing.assert_array_equal(tconv.round_tf32(torch.from_numpy(got)).numpy(), got)
    t = torch.from_numpy(x)
    for tier in TIERS:
        tconv.set_matmul_precision(tier)
        (same,) = tconv.tier_operands(t)
        assert torch.equal(same, t)


@pytest.mark.parametrize("tier", TIERS)
def test_tiers_match_jax_on_cpu(rng, tier):
    """scan_parallel and the sequential gate at every tier, port against
    JAX (neither CPU backend rounds by tier)."""
    params = _params(rng)
    tp = params_from_jax(params, "cpu")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tc, jc = _stream(11, 16)
    _set_tier(tier)
    tn, jn = _net("float32"), _net("float32", pkg=jnet)
    _, got = _scan_parallel(tn, tp, tc)
    _, want = jn.scan_parallel(jp, jn.init_state(jp), jc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    rep = trun(_net("float32", mode="sparse_pallas"), tp, tc, device="cpu")
    assert max(rep.max_diff.values()) <= TOL, rep


def test_bf16_act_async_equals_dense(rng):
    """Per-layer async == dense stays exact: both sides run the same convs
    and cast at the same spec-driven points."""
    params = params_from_jax(_params(rng), "cpu")
    chunks = tmake(rng, 300, 20, H, W, device="cpu")
    report = trun(_net("bfloat16"), params, chunks, device="cpu")
    assert max(report.max_diff.values()) <= 1e-6, report


def test_bf16_act_scan_vs_scan_parallel(rng):
    params = params_from_jax(_params(rng), "cpu")
    net = _net("bfloat16")
    chunks = tmake(rng, 40, 20, H, W, device="cpu")
    state = net.init_state(params, "cpu")
    s1, o1 = net.scan(params, state, chunks)
    s2, o2 = net.scan_parallel(params, state, chunks)
    assert o1.dtype == o2.dtype == torch.float32
    assert float((o1 - o2).abs().max()) <= 2e-2
    for a, b in zip(s1[0], s2[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-2)


def test_bf16_act_absolute_fidelity_vs_f32(rng):
    """The cast is real (outputs differ from the float32 run) and bounded
    by bf16 resolution through the shallow net."""
    params = params_from_jax(_params(rng), "cpu")
    chunks = tmake(rng, 40, 20, H, W, device="cpu")
    outs = {}
    for act in ("float32", "bfloat16"):
        net = _net(act)
        _, o = net.scan(params, net.init_state(params, "cpu"), chunks)
        assert o.dtype == torch.float32
        outs[act] = o.numpy()
    diff = np.abs(outs["bfloat16"] - outs["float32"]).max()
    assert 0 < diff <= 0.1 * np.abs(outs["float32"]).max()


def test_bf16_act_leaves_incremental_layers_f32():
    for pkg in (tnet, jnet):
        for ld in _net("bfloat16", mode="dense", pkg=pkg).event_layers[1:]:
            assert ld.spec.act_dtype == "float32"
        for ld in _net("bfloat16", mode="full", pkg=pkg).event_layers[1:]:
            assert ld.spec.act_dtype == "bfloat16"
    ld = layers_dict("conv1=3,3,1,4@dense pool1=2,2 conv2=3,3,4,8@full pool2=2,2")
    args = (ld, H, W, 1e-3, 0.1, "SAME", "dense", 0.25, 0.25, "bfloat16")
    t_ev, _ = tnet.build_layer_defs(*args)
    j_ev, _ = jnet.build_layer_defs(*args)
    assert [tuple(x) for x in t_ev] == [tuple(x) for x in j_ev]
    # the stored maps of a mixed net: f32 up to the first 'full' layer
    rng = np.random.RandomState(2)
    params = params_from_jax(_params_for(ld, rng), "cpu")
    net = tnet.EventNetwork(ld, H, W, 1e-3, padding="SAME", conv_mode="dense",
                            activation_dtype="bfloat16")
    chunks = tmake(rng, 3, 10, H, W, device="cpu")
    _, ios = net.forward(params, net.init_state(params, "cpu"),
                         type(chunks)(*(f[0] for f in chunks)))
    assert [ios[n].surface.dtype for n in ios] == [
        torch.float32, torch.float32, torch.float32, torch.bfloat16, torch.bfloat16]


def _params_for(ld, rng):
    return {k: v for name, size in ld.items() if "conv" in name for k, v in (
        (f"w_{name}", (rng.randn(*size[:2], size[2], size[3]) * 0.2).astype(np.float32)),
        (f"b_{name}", (rng.randn(size[3]) * 0.1).astype(np.float32)))}


def test_bf16_act_composes_with_stem_fusion(rng):
    """The fused pair accumulates in float32 and casts once at the pooled
    output; the direct path casts conv1's output and pools that: they
    differ by at most one bf16 rounding at the pair boundary."""
    params = params_from_jax(_params(rng), "cpu")
    chunks = tmake(rng, 40, 20, H, W, device="cpu")
    fused = _net("bfloat16", stem_fusion=True)
    assert fused._s2d_pairs and fused._fusion_active()
    outs = {}
    for name, net in (("fused", fused), ("direct", _net("bfloat16"))):
        _, o = _scan_parallel(net, params, chunks)
        assert o.dtype == torch.float32
        outs[name] = o.numpy()
    scale = max(np.abs(outs["direct"]).max(), 1.0)
    assert np.abs(outs["fused"] - outs["direct"]).max() <= 2e-2 * scale
    _, o32 = _scan_parallel(_net("float32", stem_fusion=True), params, chunks)
    assert np.abs(outs["fused"] - o32.numpy()).max() <= 0.1 * max(np.abs(o32.numpy()).max(), 1.0)


def test_bf16_act_ts_map_engine(rng):
    """The ts-map engine with bf16 activations gives the events engine's
    surfaces bit for bit and its outputs exactly (same frames, same ops)."""
    params = params_from_jax(_params(rng), "cpu")
    chunks = tmake(rng, 12, 20, H, W, device="cpu")
    net = _net("bfloat16")
    st = net.init_state(params, "cpu")
    s_e, o_e = net.scan_parallel(params, st, chunks)
    s_t, o_t = net.scan_parallel(params, st, chunks, integrate_engine="tsmap")
    assert torch.equal(s_e[0].surface, s_t[0].surface)
    assert torch.equal(o_e, o_t)


@pytest.mark.parametrize("tier", ["highest", "default"])
def test_bf16_act_matches_jax(rng, tier):
    """Port against JAX with bf16 storage: the cast itself bit for bit;
    dense maps and scan_parallel within 2e-2 of the output scale."""
    x = (rng.randn(4096) * 3).astype(np.float32)
    np.testing.assert_array_equal(
        torch.from_numpy(x).to(torch.bfloat16).float().numpy(),
        np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)))
    params = _params(rng)
    tp = params_from_jax(params, "cpu")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    _set_tier(tier)
    tn, jn = _net("bfloat16"), _net("bfloat16", pkg=jnet)
    frame = rng.rand(1, H, W).astype(np.float32)
    got = tnet.dense_forward(tn.event_layers, tp, torch.from_numpy(frame))
    want = jnet.dense_forward(jn.event_layers, jp, jnp.asarray(frame))
    for name in want:
        assert got[name].dtype == (torch.float32 if name == "intgr" else torch.bfloat16)
        g, w_ = got[name].float().numpy(), np.asarray(want[name].astype(jnp.float32))
        assert np.abs(g - w_).max() <= 2e-2 * max(np.abs(w_).max(), 1.0), name
    tc, jc = _stream(4, 16)
    for engine in ("scan_parallel", "scan"):
        _, o_t = getattr(tn, engine)(tp, tn.init_state(tp, "cpu"), tc)
        _, o_j = jax.jit(lambda s, c, e=engine: getattr(jn, e)(jp, s, c))(
            jn.init_state(jp), jc)
        assert np.abs(o_t.numpy() - np.asarray(o_j)).max() <= 2e-2 * max(
            np.abs(np.asarray(o_j)).max(), 1.0), engine


def test_bad_activation_dtype_rejected():
    with pytest.raises(ValueError, match="activation_dtype"):
        _net("float16")


def test_precision_drift_cli_on_the_cpu(capsys):
    """The drift script's cells on the CPU at 2 steps: one JSON line each,
    every cell within the reference's 1e-4, and the tier restored."""
    import json

    from async_ev_cnn_torch.scripts import precision_drift

    assert precision_drift.main(["--device", "cpu", "--steps", "2"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    cells = {(c["scale"], c["mode"], c["precision"], c.get("activation_dtype", "float32"))
             for c in lines}
    assert len(cells) == len(lines) == 12
    assert ("efcn_160x224", "dense", "default", "float32") in cells
    assert all(c["pass_1e-4"] and c["steps"] == 2 for c in lines)
    assert all(c["max_diff"] == 0.0 for c in lines if c["mode"] == "full")
    assert tconv.matmul_precision() == "highest"
