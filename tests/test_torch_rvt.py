"""RVT (a recurrent vision transformer with a YOLOX neck and head) on the
port's 'full' engine, held against the plain reference (reference/rvt.py)
on the CPU at a small size: a 64 x 64 surface, stage widths 8-64, 8
channels a head, 2 x 2 partitions, seeded weights.

Tolerance: the port folds batch norm into the convs at load, sums each
LSTM's input and hidden halves apart (the reference's one 1x1 conv over
``cat(x, h)``), and adds the residuals by ``addcmul``: the levels and the
decoded boxes and scores agree to ``REL = 1e-5`` of their largest
magnitude over several dispatches of carried state (the readings are 1e-7
to 3e-7).  Zeroed LSTM states, swapped window and grid partitions and a
dropped attention half each miss it by orders of magnitude.
"""

import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from async_ev_cnn_torch.layers import conv_stack
from async_ev_cnn_torch.layers.network import EventNetwork
from async_ev_cnn_torch.layers.types import EventChunk, LstmState
from async_ev_cnn_torch.models import head
from async_ev_cnn_torch.ops import epilogue, layer_norm, lstm_gates, rvt
from async_ev_cnn_torch.utils import profiling
from async_ev_cnn_torch.utils.checkpoint import restore_stream_state, save_stream_state
from async_ev_cnn_torch.utils.config import layers_dict, layers_dsl
from async_ev_cnn_torch.utils.serving import StreamingPipeline
from async_ev_cnn_torch.utils.weights import fold_batchnorm
from portbench import work_graph, work_rvt
from portbench.reference import efcn as surfaces_ref
from reference import rvt as ref

torch.set_num_threads(2)

REL = 1e-5
H = W = 64
S, T, E = 2, 4, 40
YAML = "async_ev_cnn_torch/configs/rvt_base_event.yml"
ARCH = ref.architecture(stage_dims=(8, 16, 32, 64), dim_head=8, partition=(2, 2))


def dsl_of(arch) -> str:
    """The reference's architecture in the port's layer DSL (the names
    that ``reference/rvt.param_shapes`` gives its weights)."""
    dims, dh, (ph, pw) = arch["stage_dims"], arch["dim_head"], arch["partition"]
    parts, c = [], arch["input_channels"]
    for k, d in enumerate(dims, 1):
        ks, st = (7, 4) if k == 1 else (3, 2)
        parts += [f"embed{k}={ks},{ks},{c},{d},{st}", f"attn{k}={d},{dh},{ph},{pw},"
                  f"{arch['mlp_ratio']}", f"lstm{k}={d}"]
        c = d
    c0, c1, c2 = arch["fpn_channels"]
    n = arch["bottlenecks"]
    parts += [f"conv_lat0=1,1,{c2},{c1}@silu", "upsample_p4=2", "route_p4=upsample_p4,lstm3",
              f"csp_p4={2 * c1},{c1},{n}", f"conv_red1=1,1,{c1},{c0}@silu", "upsample_p3=2",
              "route_p3=upsample_p3,lstm2", f"csp_p3={2 * c0},{c0},{n}",
              f"conv_bu2=3,3,{c0},{c0},2@silu", "route_n3=conv_bu2,conv_red1",
              f"csp_n3={2 * c0},{c1},{n}", f"conv_bu1=3,3,{c1},{c1},2@silu",
              "route_n4=conv_bu1,conv_lat0", f"csp_n4={2 * c1},{c2},{n}"]
    hid, cls = arch["head_width"], arch["classes"]
    for s, src, ci in zip(arch["strides"], ("csp_p3", "csp_n3", "csp_n4"), (c0, c1, c2)):
        h = f"h{s}"
        parts += [f"route_{h}={src}", f"conv_{h}_stem=1,1,{ci},{hid}@silu",
                  f"conv_{h}_c1=3,3,{hid},{hid}@silu", f"conv_{h}_c2=3,3,{hid},{hid}@silu",
                  f"conv_{h}_cls=1,1,{hid},{cls}@linear", f"route_{h}_r=conv_{h}_stem",
                  f"conv_{h}_r1=3,3,{hid},{hid}@silu", f"conv_{h}_r2=3,3,{hid},{hid}@silu",
                  f"conv_{h}_reg=1,1,{hid},4@linear", f"route_{h}_o=conv_{h}_r2",
                  f"conv_{h}_obj=1,1,{hid},1@linear",
                  f"yolox_{h}=conv_{h}_reg,conv_{h}_obj,conv_{h}_cls"]
    return " ".join(parts)


DSL = dsl_of(ARCH)


def tiny_net(**kw) -> EventNetwork:
    return EventNetwork(layers_dict(DSL), H, W, 5e-5, 0.1, "SAME", conv_mode="full",
                        stem_fusion=False, **kw)


def weights(seed=123):
    wt = ref.make_weights(ARCH, seed, "cpu")
    return wt, fold_batchnorm(wt, eps=ref.BN_EPS, form="torch")


def stream_state(net, params, streams=S):
    st = net.init_state(params, "cpu")
    return tuple(type(s)(*(f.expand(streams, *f.shape).clone() for f in s)) for s in st)


def dispatches(n=3, seed=0):
    """``n`` dispatches of S streams x T chunks of E events, and the
    reference's chunk-boundary surfaces of each."""
    g = torch.Generator().manual_seed(seed)
    chain = surfaces_ref.SurfaceChain(S, H, W, 5e-5, "cpu")
    out = []
    for d in range(n):
        y = torch.randint(0, H, (S, T, E), generator=g)
        x = torch.randint(0, W, (S, T, E), generator=g)
        ts = (torch.arange(T * E).reshape(1, T, E).expand(S, T, E) + d * T * E) * 3
        valid = torch.rand(S, T, E, generator=g) < 0.9
        chunks = EventChunk(y.int(), x.int(), ts.int(), torch.zeros_like(y).int(), valid)
        out.append((chunks, chain.run(y, x, ts, valid, range(T))))
    return out


def rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def worst_gap(n=3, net=None, between=None) -> float:
    """The largest gap of the program's levels and decoded outputs to the
    reference's over ``n`` dispatches; ``between(state)`` may change the
    program's state between dispatches."""
    net = net or tiny_net()
    wt, params = weights()
    st, carry, worst = stream_state(net, params), None, 0.0
    for chunks, surfaces in dispatches(n):
        st, outs = net.scan_parallel(params, st, chunks)
        want, carry = ref.forward(wt, ARCH, surfaces[:, :, None], carry)
        got_dec = head.decode_yolox(outs, net.head_strides)
        want_dec = ref.decode(want, ARCH["strides"])
        for a, b in zip((*outs, *got_dec), (*want, *want_dec)):
            worst = max(worst, rel(a, b))
        st = between(st) if between else st
    return worst


# ---- the program against the reference --------------------------------

def test_the_program_is_the_reference_over_dispatches_of_carried_state():
    gap = worst_gap()
    assert gap <= REL, f"the program's levels or decoded boxes are {gap:.3g} from the reference"


def _zeroed(st):
    return tuple(LstmState(torch.zeros_like(s.h), torch.zeros_like(s.c))
                 if isinstance(s, LstmState) else s for s in st)


def _swap(fn, at):
    """``fn`` with its partition kind, argument ``at``, swapped."""
    def swapped(*args):
        args = list(args)
        if at < len(args):
            args[at] = {"win": "grid", "grid": "win"}.get(args[at], args[at])
        return fn(*args)
    return swapped


@pytest.mark.parametrize("fault", ["zero the LSTM states at each dispatch",
                                   "swap the window and grid partitions",
                                   "drop the grid attention half"])
def test_each_fault_misses_the_tolerance(monkeypatch, fault):
    between = None
    if fault.startswith("zero"):
        between = _zeroed
    elif fault.startswith("swap"):
        monkeypatch.setattr(layer_norm, "layer_norm", _swap(layer_norm.layer_norm, 4))
        monkeypatch.setattr(rvt, "add_partitions", _swap(rvt.add_partitions, 5))
    else:
        monkeypatch.setattr(rvt, "HALVES", rvt.HALVES[:1])
    gap = worst_gap(between=between)
    assert gap > 100 * REL, f"with the fault '{fault}' the gap {gap:.3g} stays within {REL}"


def test_the_state_carries_across_window_slices():
    net = tiny_net()
    _, params = weights()
    (chunks, _), = dispatches(1)
    whole, outs = net.scan_parallel(params, stream_state(net, params), chunks)
    sliced, parts = net.scan_parallel(params, stream_state(net, params), chunks, window=1)
    for a, b in zip(outs, parts):
        assert rel(b, a) <= REL, "a window of one chunk gives other levels"
    lstm = [i for i, s in enumerate(whole) if isinstance(s, LstmState)]
    assert len(lstm) == 4
    for i in lstm:
        assert rel(sliced[i].h, whole[i].h) <= REL and rel(sliced[i].c, whole[i].c) <= REL, (
            f"state {i}: the windows' carried (h, c) is not the whole dispatch's")


def test_a_stream_is_its_own_call_and_the_steps_are_counted():
    net = tiny_net()
    _, params = weights()
    (chunks, _), = dispatches(1)
    net.reset_counts()
    st, outs = net.scan_parallel(params, stream_state(net, params), chunks)
    assert sum(c["recurrent_steps"] for c in net.layer_counts.values()) == 4 * T
    one = EventChunk(*(f[1] for f in chunks))
    st1, outs1 = net.scan_parallel(params, net.init_state(params, "cpu"), one)
    for a, b in zip(outs, outs1):
        assert rel(a[1], b) <= REL, "stream 1 of a batched call is not its own call"


def test_the_pipeline_serves_and_the_state_round_trips(tmp_path):
    net = tiny_net()
    _, params = weights()
    pipe = StreamingPipeline(net, params, capacity=E, streams=S, t_chunks=T, device="cpu",
                             postprocess=lambda outs: head.decode_yolox(outs, net.head_strides))
    rng = np.random.RandomState(3)
    items = []
    for s in range(S):
        ev = np.stack([rng.randint(0, H, T * E), rng.randint(0, W, T * E),
                       np.sort(rng.randint(0, 10000, T * E))], axis=1)
        items.append(ev)
    res = list(pipe.serve(items))
    assert len(res) == 1
    boxes, scores, probs = res[0].outputs
    n = sum((H // s) * (W // s) for s in (8, 16, 32))
    assert boxes.shape == (S, T, n, 4) and probs.shape == (S, T, n, ARCH["classes"])
    path = tmp_path / "state.npz"
    save_stream_state(str(path), pipe.state)
    back = restore_stream_state(str(path), pipe.state)
    for a, b in zip(pipe.state, back):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert any(isinstance(s, LstmState) and s.h.abs().max() > 0 for s in back)


# ---- the model and its description ------------------------------------

def test_the_reference_has_rvt_bs_parameters():
    n = ref.parameter_count(ref.architecture(input_channels=20))
    assert abs(n - 18.5e6) <= 0.01 * 18.5e6, f"{n:,} parameters: a width is wrong"
    assert n == 18_536_856
    assert ref.parameter_count(ref.architecture()) == 18_477_272


def _yaml_layers() -> str:
    return open(YAML).read().split("yolo_cnn_layers: ")[1].split("\n")[0]


@pytest.mark.parametrize("text", [DSL, "_yaml"])
def test_the_dsl_round_trips_the_rvt_tokens(text):
    text = _yaml_layers() if text == "_yaml" else text
    d = layers_dict(text)
    assert layers_dsl(d) == text
    assert {"conv_lat0", "conv_bu2"} <= d.silu and "conv_h8_cls" in d.linear


def test_the_published_network_builds_at_384_by_640():
    net = EventNetwork(layers_dict(_yaml_layers()), 384, 640, 5e-5, 0.1, "SAME",
                       conv_mode="full", stem_fusion=False)
    shapes = {ld.name: ld.spec.out_shape for ld in net.event_layers[1:]}
    assert [shapes[f"lstm{k}"] for k in range(1, 5)] == [
        (64, 96, 160), (128, 48, 80), (256, 24, 40), (512, 12, 20)]
    assert [shapes[n] for n in net.heads] == [(8, 48, 80), (8, 24, 40), (8, 12, 20)]
    assert net.head_strides == (8, 16, 32) and net.recurrent == tuple(
        f"lstm{k}" for k in range(1, 5))
    attn = [ld.spec for ld in net.event_layers if ld.kind == "attn"]
    assert [a.heads for a in attn] == [2, 4, 8, 16] and all(a.skip_first_norm for a in attn)
    assert all(isinstance(s, LstmState) for s in (
        net.init_state({}, "cpu")[1 + i] for i, ld in enumerate(net.event_layers[1:])
        if ld.kind == "lstm"))


@pytest.mark.parametrize("mode", ["sparse", "dense", "sparse_pallas", "window"])
@pytest.mark.parametrize("token", ["embed1=7,7,1,8,4", "conv1=3,3,1,8,2",
                                   "conv1=3,3,1,8@silu"])
def test_the_incremental_modes_refuse_the_rvt_tokens(mode, token):
    with pytest.raises(ValueError, match="runs only in conv_mode 'full'"):
        EventNetwork(layers_dict(token), H, W, 5e-5, 0.1, "SAME", conv_mode=mode)


@pytest.mark.parametrize("token", ["attn1=8,8,2,2,4", "lstm1=8", "csp1=8,8,1"])
def test_the_incremental_modes_refuse_the_later_rvt_tokens(token):
    with pytest.raises(ValueError, match="runs only in conv_mode 'full'"):
        EventNetwork(layers_dict("embed1=7,7,1,8,4 " + token), H, W, 5e-5, 0.1, "SAME",
                     conv_mode="sparse")
    with pytest.raises(ValueError, match="float32 activations"):
        EventNetwork(layers_dict("embed1=7,7,1,8,4 " + token), H, W, 5e-5, 0.1, "SAME",
                     conv_mode="full", activation_dtype="bfloat16")


def test_a_partition_that_does_not_tile_is_refused():
    with pytest.raises(ValueError, match="does not fit"):
        EventNetwork(layers_dict("embed1=7,7,1,8,4 attn1=8,8,3,3,4"), H, W, 5e-5, 0.1,
                     "SAME", conv_mode="full")


def test_time_sharding_refuses_the_lstms():
    from async_ev_cnn_torch.parallel.time_shard import TimeShardEngine

    with pytest.raises(ValueError, match="step through them in order"):
        TimeShardEngine(tiny_net(), None)


def test_the_sequential_engine_refuses_rvt():
    net = tiny_net()
    with pytest.raises(ValueError, match="sequential engine"):
        net.forward({}, net.init_state({}, "cpu"), None)


# ---- the pieces ---------------------------------------------------------

@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
def test_the_epilogues_silu_form_is_silu_of_the_biased_conv(rng, act_dtype):
    raw = torch.from_numpy(rng.randn(2, 3, 5, 7).astype(np.float32)) * 4
    bias = torch.from_numpy(rng.randn(3).astype(np.float32))
    got = epilogue.conv_epilogue(raw.clone(), bias, 0.1, act_dtype, act="silu")
    want = F.silu(raw + bias.reshape(-1, 1, 1)).to(getattr(torch, act_dtype))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="unpooled"):
        epilogue.conv_epilogue(raw.clone(), bias, 0.1, pooled=True, act="silu")


@pytest.mark.parametrize("kind", ["win", "grid"])
def test_partition_is_the_references_and_add_partitions_inverts_it(kind):
    x = torch.randn(3, 12, 20, 5)
    p = layer_norm.partition(x, 6, 10, kind)
    want = (ref.window_partition if kind == "win" else ref.grid_partition)(x, (6, 10))
    assert torch.equal(p, want.reshape(p.shape))
    back = torch.zeros_like(x)
    rvt.add_partitions(back, p, torch.ones(5), 6, 10, kind)
    assert torch.equal(back, x)


def test_the_lstm_scan_is_the_published_cell():
    g = torch.Generator().manual_seed(5)
    t, r, c = 3, 6, 4
    x = torch.randn(t, r, c, generator=g)
    h0, c0 = torch.randn(r, c, generator=g), torch.randn(r, c, generator=g)
    w = torch.randn(4 * c, 2 * c, 1, 1, generator=g) * 0.3
    b = torch.randn(4 * c, generator=g) * 0.1
    seq, hn, cn = rvt.lstm_scan(x, h0, c0.clone(), w, b)
    h, cc = h0, c0
    for k in range(t):
        mix = torch.cat([x[k], h], -1) @ w[:, :, 0, 0].t() + b
        f, i, o = torch.sigmoid(mix[..., :3 * c]).chunk(3, -1)
        cc = f * cc + i * torch.tanh(mix[..., 3 * c:])
        h = o * torch.tanh(cc)
        assert rel(seq[k], h) <= REL
    assert rel(hn, h) <= REL and rel(cn, cc) <= REL


def test_the_lstm_scan_updates_a_row_major_cell_from_a_transposed_state():
    # one stream's state [C, H, W] reaches the scan as a transposed view of
    # its rows; G1 on the card takes the cell row-major
    g = torch.Generator().manual_seed(5)
    t, r, c = 3, 6, 4
    x = torch.randn(t, r, c, generator=g)
    h0 = torch.randn(c, r, generator=g).t()
    c0 = torch.randn(c, r, generator=g).t()
    w = torch.randn(4 * c, 2 * c, 1, 1, generator=g) * 0.5
    b = torch.randn(4 * c, generator=g)
    seq, hn, cn = rvt.lstm_scan(x, h0, c0, w, b)
    assert cn.is_contiguous() and hn.is_contiguous(), "the scan's state is not row-major"
    want = rvt.lstm_scan(x, h0.contiguous(), c0.contiguous(), w, b)
    for a, e in zip((seq, hn, cn), want):
        assert torch.equal(a, e), "a transposed state gives another scan"


def test_decode_yolox_is_the_references():
    g = torch.Generator().manual_seed(2)
    levels = [torch.randn(2, 3, gh, gw, 8, generator=g) for gh, gw in ((8, 8), (4, 4), (2, 2))]
    for a, b in zip(head.decode_yolox(levels, (8, 16, 32)), ref.decode(levels, (8, 16, 32))):
        assert rel(a, b) <= 1e-6


def test_fold_batchnorm_in_torch_form_is_batchnorm2d():
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 3, 5, 5, generator=g)
    p = {"w_c": torch.randn(4, 3, 3, 3, generator=g), "gamma_c": torch.rand(4) + 0.5,
         "beta_c": torch.randn(4), "mean_c": torch.randn(4), "var_c": torch.rand(4) + 0.5}
    want = F.batch_norm(F.conv2d(x, p["w_c"], padding=1), p["mean_c"], p["var_c"],
                        p["gamma_c"], p["beta_c"], eps=1e-3)
    f = fold_batchnorm(p, eps=1e-3, form="torch")
    assert rel(F.conv2d(x, f["w_c"], f["b_c"], padding=1), want) <= REL
    with pytest.raises(ValueError):
        fold_batchnorm(p, form="caffe")


def test_the_memory_model_counts_the_rvt_layers():
    net = tiny_net()
    per = net.parallel_live_bytes_per_chunk()
    # the embedding of stage 1 holds the surface, its conv's map and the normed one
    embed = 8 * (H // 4) * (W // 4)
    assert per >= 4 * (2 * H * W + H * W + 2 * embed)
    # beside them the largest transient block (here stage 1's pair: 9C
    # floats a token of the window's frames; its LSTM's gates are 4C a
    # pixel) and the workspace of the convs whose algorithm cuDNN times
    pair = 4 * 9 * 8 * 5 * (H // 4) * (W // 4)
    assert net.parallel_transient_bytes(5) == pair + conv_stack.TIMED_WORKSPACE_BYTES
    fit = 2 * per * 32 + net.parallel_transient_bytes(32)
    assert net.auto_window(1024, fit / 2**20) == 32
    assert net.auto_window(1024, (fit - 1) / 2**20) == 24, "a window overran the budget"
    assert net.auto_window(1024, conv_stack.TIMED_WORKSPACE_BYTES / 2**20) == 1
    # a small budget slices the dispatch, and changes no output
    _, params = weights()
    (chunks, _), = dispatches(1)
    budget = (2 * per * 2 + net.parallel_transient_bytes(2)) / 2**20
    assert net.auto_window(T, budget) == 2
    _, whole = net.scan_parallel(params, stream_state(net, params), chunks)
    _, sliced = net.scan_parallel(params, stream_state(net, params), chunks,
                                  window_budget_mb=budget)
    for a, b in zip(whole, sliced):
        assert rel(b, a) <= REL, "the budget's windows give other levels"


def test_the_spans_of_a_pair_and_an_lstm_are_recorded():
    net = tiny_net()
    _, params = weights()
    (chunks, _), = dispatches(1)
    profiling.clear()
    with profiling.recording():
        net.scan_parallel(params, stream_state(net, params), chunks)
        names = [s[0] for s in profiling.recorded()]
    profiling.clear()
    for name in ("attn.window", "attn.grid", "mlp", "lstm.input", "lstm.scan",
                 "layer.embed1", "layer.attn1", "layer.lstm1", "layer.csp_p4",
                 "layer.yolox_h8", "conv.leaky"):
        assert name in names, f"no {name} span"
    assert names.count("attn.window") == names.count("attn.grid") == 4
    assert names.count("lstm.scan") == 4
    out = head.decode_yolox([torch.zeros(1, 2, 2, 8)], (8,))
    assert out[0].shape == (1, 4, 4)


# ---- the benchmark's count and readers ----------------------------------

def test_the_shape_walk_counts_the_references_operations():
    from torch.utils.flop_counter import FlopCounterMode

    wt, _ = weights()
    counter = FlopCounterMode(display=False)
    with counter:
        ref.step(wt, ARCH, torch.rand(1, 1, H, W))
    assert work_rvt.frame_flops(layers_dict(DSL), H, W) == counter.get_total_flops()


@pytest.mark.parametrize("config, flops", [("efcn_full", 353_740_800),
                                           ("yolov3tiny_full", 5_465_281_536),
                                           ("rvt_base_full", 29_428_776_960)])
def test_the_shape_walk_keeps_each_configurations_count(config, flops):
    cfg = json.loads(Path(f"portbench/configs/{config}.json").read_text())
    assert work_rvt.frame_flops(cfg["layers"], cfg["frame_h"], cfg["frame_w"]) == flops
    if config != "rvt_base_full":
        assert work_graph.frame_flops(cfg["layers"], cfg["frame_h"], cfg["frame_w"]) == flops


def test_the_attention_and_lstm_operations_a_frame():
    cfg = json.loads(Path("portbench/configs/rvt_base_full.json").read_text())
    per = work_rvt.layer_flops(cfg["layers"], 384, 640)
    attn = sum(v for k, v in per.items() if "attn" in k)
    lstm = sum(v for k, v in per.items() if "lstm" in k)
    assert round(attn / 1e9, 2) == 12.96 and round(lstm / 1e9, 2) == 4.03


@pytest.mark.parametrize("kind", [None, "win", "grid"])
def test_l1s_plain_version_is_layer_norm_then_the_partition(kind):
    x = torch.randn(2, 4, 6, 8).permute(0, 1, 2, 3)
    g, b = torch.rand(8) + 0.5, torch.randn(8)
    got = layer_norm.layer_norm(x, g, b, 1e-5, kind, 2, 3)
    y = F.layer_norm(x, (8,), g, b, 1e-5)
    assert torch.equal(got, y if kind is None else layer_norm.partition(y, 2, 3, kind))
    assert torch.equal(layer_norm.layer_norm(x, None, None, 1e-5, kind, 2, 3),
                       x if kind is None else layer_norm.partition(x, 2, 3, kind))
    with pytest.raises(ValueError, match="tiles of a frame"):
        layer_norm.layer_norm(x, g, b, 1e-5, "win", 3, 3)


def test_l1s_bytes_are_five_passes_a_stage():
    cfg = json.loads(Path("portbench/configs/rvt_base_full.json").read_text())
    tokens = [(96 * 160, 64), (48 * 80, 128), (24 * 40, 256), (12 * 20, 512)]
    want = sum(5 * 2 * 4 * p * c for p, c in tokens)
    assert work_rvt.layer_norm_bytes(cfg["layers"], 384, 640) == want == 73_728_000


def test_g1s_plain_version_is_the_published_cell():
    g = torch.Generator().manual_seed(8)
    gates, c = torch.randn(6, 16, generator=g), torch.randn(6, 4, generator=g)
    f, i, o, z = gates.split(4, dim=1)
    want_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(z)
    want_h = torch.sigmoid(o) * torch.tanh(want_c)
    h = torch.empty(6, 4)
    got = lstm_gates.lstm_gates(gates.clone(), c, h)
    assert got is h and rel(h, want_h) <= 1e-6 and rel(c, want_c) <= 1e-6
    with pytest.raises(ValueError, match="g \\[R, 4C\\]"):
        lstm_gates.lstm_gates(torch.zeros(6, 12), c, h)


def test_g1s_bytes_are_28_a_channel_of_a_pixel():
    cfg = json.loads(Path("portbench/configs/rvt_base_full.json").read_text())
    tokens = [(96 * 160, 64), (48 * 80, 128), (24 * 40, 256), (12 * 20, 512)]
    assert work_rvt.lstm_gate_bytes(cfg["layers"], 384, 640) == sum(
        28 * p * c for p, c in tokens) == 51_609_600


def _reader(name):
    from portbench.run import load

    return load(Path(__file__).resolve().parents[1], "metrics", name)


def test_the_rvt_readers_take_device_time_a_dispatch_or_nothing(monkeypatch):
    from portbench.harness import Record, Request
    from portbench.tracing import WINDOW_RANGE, TraceEvents

    box = []
    monkeypatch.setattr(profiling, "recorded", lambda: list(box))

    def span(name, t0, t1, request=0):
        return (name, t0, t1, None, request, 1)

    box += [span("serve.dispatch", 1000, 1900), span("layer.attn1", 1010, 1300),
            span("attn.window", 1010, 1100), span("attn.grid", 1100, 1200),
            span("mlp", 1200, 1300), span("layer.lstm4", 1300, 1500),
            span("lstm.input", 1300, 1350), span("lstm.scan", 1350, 1500),
            span("layer.conv_lat0", 1500, 1600), span("layer.yolox_h8", 1600, 1700)]
    rec = Record(seconds=1.0, t_start=0.0)
    rec.requests = [Request(0.0, 200, 1) for _ in range(4)]
    rec.config = {"layers": {"attn1": [], "lstm4": [], "conv_lat0": [], "yolox_h8": []}}
    device = [("k", 1020, 1060, 1015), ("k", 1120, 1140, 1110), ("k", 1360, 1400, 1355),
              ("k", 1510, 1530, 1505), ("k", 1610, 1615, 1605)]
    rec.trace = TraceEvents([(WINDOW_RANGE, 1000, 2000)], [], device)
    assert _reader("attn_ms.rvt").read(rec) == pytest.approx(60 / 1e6)
    assert _reader("lstm_ms.rvt").read(rec) == pytest.approx(40 / 1e6)
    assert _reader("neck_head_ms.rvt").read(rec) == pytest.approx(25 / 1e6)
    rec.counters = {"lstm_steps": 512, "dispatches": 2}
    assert _reader("lstm_steps_per_dispatch.rvt").read(rec) == 256
    box.append(span("norm.l1", 1015, 1095))
    rec.mix = {"streams": 1, "chunks": 2}
    rec.config = {"layers": {"attn1": [1, 1, 1, 1, 4], "lstm4": [1],
                             "conv_lat0": [1, 1, 1, 4], "yolox_h8": ["conv_lat0"]},
                  "frame_h": 4, "frame_w": 4}
    least = 2 * (4 * 2 * 4 * 16) / 3.35e12  # 2 frames of 16 tokens of one channel
    assert _reader("layer_norm_roofline.rvt").read(rec) == pytest.approx(
        100 * least / (40e-9))
    box.append(span("lstm.gates", 1355, 1405))
    rec.config["layers"] = {"embed1": [1, 1, 1, 4, 1], "lstm1": [4], "conv_lat0": [1, 1, 4, 4]}
    least = 2 * (28 * 4 * 16) / 3.35e12  # 2 frames of 16 pixels of 4 channels
    assert _reader("lstm_gates_roofline.rvt").read(rec) == pytest.approx(
        100 * least / (40e-9))
    box[:] = [span("serve.dispatch", 1000, 1900)]  # a program without RVT's spans
    assert all(_reader(n).read(rec) is None for n in (
        "attn_ms.rvt", "lstm_ms.rvt", "neck_head_ms.rvt", "layer_norm_roofline.rvt",
        "lstm_gates_roofline.rvt"))
    rec.counters = {"dispatches": 2}
    assert _reader("lstm_steps_per_dispatch.rvt").read(rec) is None


# ---- the serve CLI and the benchmark's cell at a tiny size ---------------

def test_the_serve_cli_runs_the_rvt_yaml_with_out_and_state(tmp_path, rng):
    from async_ev_cnn_torch.data.file_reader import NReader
    from async_ev_cnn_torch.scripts import serve
    from async_ev_cnn_torch.utils.checkpoint import save_params

    reader = NReader()
    root = tmp_path / "det"
    (root / "annotations").mkdir(parents=True)
    for split, k in (("train", 1), ("test", 3), ("validation", 1)):
        (root / split).mkdir()
        for i in range(k):
            n = 300
            name = f"{split}_ex{i}"
            reader.save_example(str(root / split / f"{name}.bin"),
                                rng.randint(0, W, n).astype(np.int32),
                                rng.randint(0, H, n).astype(np.int32),
                                np.sort(rng.randint(0, 60000, n)).astype(np.int32),
                                rng.randint(0, 2, n).astype(np.int32))
            np.save(str(root / "annotations" / f"{name}.npy"), rng.rand(1, 6).astype(np.float32))
    np.savez(str(root / "params.npz"), num_classes=3,
             label_to_idx=np.array([(f"c{i}", i) for i in range(3)], dtype=object))
    # the checkpoint convention: HWIO kernels, batch norm folded
    _, params = weights(seed=11)
    ckpt = tmp_path / "weights.npz"
    save_params(str(ckpt), {k: (v.permute(2, 3, 1, 0) if k.startswith("w_") else v).numpy()
                            for k, v in params.items()})
    out, state = tmp_path / "dets.jsonl", tmp_path / "state.npz"
    args = ["--device", "cpu", "-c", YAML, "--input_data_dir", str(root),
            "--restore_net", str(ckpt), "--frame_h", str(H), "--frame_w", str(W),
            "--example_h", str(H), "--example_w", str(W), "--yolo_cnn_layers", DSL,
            "--batch_event_size", "50", "--serve_chunks", "4", "--num_streams", "2",
            "--out", str(out), "--conf_threshold", "0.0", "--serve_state", str(state)]
    stats = serve.main(args)
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert stats["dispatches"] >= 1 and stats["detections_written"] == len(lines) > 0
    assert all(0 <= d["class"] < 3 and len(d["bbox_xywh"]) == 4 for d in lines)
    assert serve.main(args)["state_restored"]


def tiny_bench(dest):
    """A checkout-like root: the benchmark's files and a tiny RVT cell (this
    file's widths, 64 x 64), with the repo's metrics of it."""
    repo = Path(__file__).resolve().parents[1]
    shutil.copytree(repo / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = dest / "portbench"
    cfg = json.loads((pb / "configs" / "rvt_base_full.json").read_text())
    d = layers_dict(DSL)
    cfg.update(frame_h=H, frame_w=W, layers=dict(d), linear=sorted(d.linear),
               silu=sorted(d.silu), stage_dims=list(ARCH["stage_dims"]), embed_dim=8,
               dim_head=8, partition=[2, 2], serve_chunks=4, events_per_chunk=16)
    (pb / "configs" / "tiny_rvt.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "tiny_replay.json").write_text(json.dumps(
        {"loop": "closed", "streams": 2, "chunks": 4, "events_per_chunk": 16,
         "pixels": "clustered", "radius": 3, "ts_gap_us": [1, 14], "pool": 3,
         "warmup_requests": 2}))
    limits = {"out_gap": {"limit": REL}, "surface_gap": {"limit": 1e-6}}
    (pb / "limits" / "t.rvt.json").write_text(json.dumps(limits))
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    stands = {"rvt_base_full.replay_s16": "t.rvt"}
    bench["configs"] = [{"name": "tiny_rvt", "source": "tests",
                         "file": "portbench/configs/tiny_rvt.json", "reduced": [], "why": "tiny"}]
    bench["workloads"] = [{"name": "t.rvt", "config": "tiny_rvt", "traffic": "tiny_replay",
                           "chips": 1, "why": "tiny"}]
    for section in ("end_to_end", "per_layer"):
        bench[section] = [dict(m, workloads=[stands[w] for w in m["workloads"] if w in stands])
                          if "workloads" in m else m for m in bench[section]]
        bench[section] = [m for m in bench[section] if m.get("workloads", [1])]
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


def _run(root, trace=False):
    from portbench.run import run_cell

    return run_cell(root, "t.rvt", 2**31 + 93, 1.0, trace, "cpu", t0=time.perf_counter())


def test_a_tiny_run_of_the_rvt_cell_is_correct(tmp_path):
    root = tiny_bench(tmp_path)
    result, lines = _run(root)
    assert result["correct"], lines
    assert set(result["metrics"]) == {"events_per_s", "setup_s"}
    assert result["attempted"] > 1 and result["failed"] == 0
    traced, lines = _run(root, trace=True)
    assert traced["correct"], lines
    # a CPU run reads no device metric
    assert set(traced["metrics"]) == {"mfu.rvt", "lstm_steps_per_dispatch.rvt"}
    assert traced["metrics"]["lstm_steps_per_dispatch.rvt"]["value"] == 16


def test_the_rvt_cell_with_the_state_zeroed_is_not_correct(tmp_path, monkeypatch):
    root = tiny_bench(tmp_path)
    scan = EventNetwork.scan_parallel

    def forgetful(self, params, state, chunks, **kw):
        return scan(self, params, _zeroed(state), chunks, **kw)

    monkeypatch.setattr(EventNetwork, "scan_parallel", forgetful)
    result, lines = _run(root)
    assert not result["correct"], lines
    assert result["checks"]["out_gap"]["value"] > 100 * REL


def test_a_conv_stack_route_for_every_rvt_kind():
    assert {"embed", "attn", "lstm", "csp", "yolox"} <= set(conv_stack.RUNS)
    steps = conv_stack.plan(tiny_net(), "cpu")
    assert [s.route for s in steps[:3]] == ["embed", "attn", "lstm"]
