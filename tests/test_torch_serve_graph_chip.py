"""On the card: the serving loop replays each one-stream dispatch of a
'full' network as a captured CUDA graph (utils/serving.py), and a replay
gives what the eager dispatch gives, bit for bit.

The eFCN and YOLOv3-tiny (a stateless graph network with routes) each
serve the same 44 one-stream dispatches of 64 chunks of 200 events twice:
eagerly (``serving.graph_dispatch`` patched to refuse every dispatch) and
through the graph path.  On the way the stream is rebased (its clock
passes 2**30 us: a nonzero prev_ts shift), its events leave the ultra4
wire for the ultra wire (a new key), a state saved earlier is restored
through the ``state`` setter, and a weight is written in place (a new
version, so every graph is captured anew).  The outputs, the decoded
boxes and the states of every dispatch are the eager ones, and nothing
handed out is overwritten by a later replay.  The kernels' launch
counters count what their wrappers launch: an eager dispatch's launches
and a capture's, a replay none; a profiler trace of replays holds each
hand-written kernel (K1, K6, C1, E1) as often as an eager dispatch
launches it.  Two pipelines that share a network with other weights each
replay their own.  A 16-stream pipeline and a recurrent network (RVT-B)
dispatch eagerly.

No JAX here: run it on the card's machine without the tests' conftest:

    python -m pytest --noconftest -p no:cacheprovider -m chip tests/test_torch_serve_graph_chip.py
"""

import numpy as np
import pytest
import torch

from async_ev_cnn_torch.layers import conv_stack
from async_ev_cnn_torch.layers.network import EventNetwork
from async_ev_cnn_torch.models import head
from async_ev_cnn_torch.ops import conv_pool, epilogue, fused_stem, surface_scan
from async_ev_cnn_torch.ops.conv import set_matmul_precision
from async_ev_cnn_torch.utils import serving
from async_ev_cnn_torch.utils.config import layers_dict
from async_ev_cnn_torch.utils.weights import fold_batchnorm
from reference import rvt as rvt_ref
from reference import yolov3_tiny as y3t_ref

EFCN = ("conv1=3,3,1,16 pool1=2,2 conv2=3,3,16,32 pool2=2,2 conv3=3,3,32,64 pool3=2,2 "
        "conv4=3,3,64,128 pool4=2,2 conv5=3,3,128,256 pool5=2,2 conv6=1,1,256,512 "
        "conv7=1,1,512,110")
T, E = 64, 200
DISPATCHES = 44
#: the dispatch whose events pass 2**30 us: the pipeline rebases the stream
REBASE_AT = 14
#: from this dispatch on the events are 16-40 us apart: the ultra wire
ULTRA_AT = 22
#: the state after dispatch SAVED is restored before dispatch RESTORE_AT
SAVED, RESTORE_AT = 8, 28
#: a weight is written in place before this dispatch
WEIGHT_AT = 34
#: the dispatch whose state and outputs are held 20 dispatches on
HELD = 10
#: the dispatches that run eagerly (a key's first) and that capture (its
#: second): the first key's, the ultra wire's, and the first key's again
#: after the weight moved (its version is part of every key)
EAGER = (0, ULTRA_AT, WEIGHT_AT)
CAPTURED = (1, ULTRA_AT + 1, WEIGHT_AT + 1)
COUNTERS = (surface_scan.LAUNCHES, fused_stem.LAUNCHES, conv_pool.LAUNCHES, epilogue.LAUNCHES)
#: each counted launch's kernels, by a part of their names: K1 is a binning
#: and a scan kernel, E1 the pooled or the plain epilogue
KERNELS = {"surface_scan_events": ("bin_events_kernel", "scan_events_kernel"),
           "fused_stem": ("fused_stem_kernel",), "conv_pool": ("conv_pool_kernel",),
           "conv_epilogue": ("pool_epilogue_kernel|act_epilogue_kernel",)}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file with pytest --noconftest -m chip there")
    set_matmul_precision("highest")
    yield torch.device("cuda", 0)
    set_matmul_precision("highest")
    torch.cuda.empty_cache()


def _items(h, w):
    """The stream's items: uniform pixels below 256 (the sub-plain wires'
    coordinates), gaps of 0-7 us, then 16-40 us from ULTRA_AT; 2**30 us
    added from REBASE_AT."""
    rng = np.random.RandomState(24)
    items, t0 = [], 0
    for k in range(DISPATCHES):
        gaps = rng.randint(16, 41, T * E) if k >= ULTRA_AT else rng.randint(0, 8, T * E)
        ts = t0 + np.cumsum(gaps)
        t0 = int(ts[-1]) + 1
        items.append(np.stack([rng.randint(0, min(h, 256), T * E),
                               rng.randint(0, min(w, 256), T * E),
                               ts + (2**30 if k >= REBASE_AT else 0)], axis=-1))
    return items


def _efcn(card):
    net = EventNetwork(layers_dict(EFCN), 160, 224, 5e-5, 0.1, "SAME", conv_mode="full",
                       stem_fusion=False)
    g = torch.Generator(device=card).manual_seed(5)
    params = {}
    for name, size in layers_dict(EFCN).items():
        if "conv" in name:
            kh, kw, cin, cout = size
            params[f"w_{name}"] = torch.randn(cout, cin, kh, kw, generator=g, device=card) * 0.05
            params[f"b_{name}"] = torch.randn(cout, generator=g, device=card) * 0.05

    def post(outs):
        boxes, _, probs = head.decode(outs, 100, 2, 160, 224)
        return outs, outs.clone(), boxes, probs

    return net, params, post


def _yolov3_tiny(card):
    layers = y3t_ref.darknet_layers()
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
            2 / (cin * k * k)) ** 0.5 * (1.0 if layer["bn"] else 0.2)
        for stat in ("gamma", "var", "beta", "mean") if layer["bn"] else ("b",):
            w[f"{stat}_conv{i}"] = (torch.rand(cout, generator=g, device=card) + 0.5
                                    if stat in ("gamma", "var")
                                    else torch.randn(cout, generator=g, device=card) * 0.1)

    def post(outs):
        boxes, _, probs = head.decode_yolov3(outs, y3t_ref.ANCHORS, y3t_ref.MASKS, 416, 416)
        return outs, tuple(o.clone() for o in outs), boxes, probs

    return net, fold_batchnorm(w), post


#: each model, its frame and the weight written in place: the stem's,
#: whose taps K6 takes by value
MODELS = {"efcn": (_efcn, (160, 224), "w_conv1"),
          "yolov3_tiny": (_yolov3_tiny, (416, 416), "w_conv0")}


def _launches():
    return [dict(c) for c in COUNTERS]


def _serve(card, model):
    """One pipeline over the model's items: its results, the state after
    each dispatch (as the pipeline handed it out), the launches counted
    by each dispatch, the state after HELD and its copy made then, and the
    pipeline's stats."""
    make, (h, w), weight = MODELS[model]
    net, params, post = make(card)
    pipe = serving.StreamingPipeline(net, params, capacity=E, t_chunks=T, postprocess=post,
                                     device=card)
    states, counts, kept = [], [_launches()], {}

    def source():
        for k, item in enumerate(_items(h, w)):
            if k:  # the pipeline has dispatched k - 1
                states.append(pipe.state)
                counts.append(_launches())
            if k == SAVED + 1:
                kept["saved"] = tuple(type(s)(*(f.clone() for f in s)) for s in pipe.state)
            if k == HELD + 1:
                kept["held"] = (pipe.state, tuple(f.clone() for f in pipe.state[0]))
            if k == RESTORE_AT:
                pipe.state = kept["saved"]
            if k == WEIGHT_AT:
                params[weight].mul_(1.25)
            yield item
        states.append(pipe.state)
        counts.append(_launches())

    results = list(pipe.serve(source()))
    torch.cuda.synchronize()
    per_dispatch = [[{k: b[k] - a[k] for k in a} for a, b in zip(c0, c1)]
                    for c0, c1 in zip(counts, counts[1:])]
    return results, states, per_dispatch, kept, dict(pipe.stats)


@pytest.fixture(scope="module", params=sorted(MODELS))
def runs(card, request):
    """Each model's two runs: eager, then through the graph path."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serving, "graph_dispatch", lambda *args: False)
        eager = _serve(card, request.param)
    return eager, _serve(card, request.param)


def _tensors(x):
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return [x]


@pytest.mark.chip
def test_replays_give_the_eager_outputs_and_states_bit_for_bit(runs):
    (e_res, e_states, _, _, _), (g_res, g_states, _, _, _) = runs
    assert len(e_res) == len(g_res) == DISPATCHES
    for k, (a, b) in enumerate(zip(e_res, g_res)):
        assert a.n_events == b.n_events == T * E
        got, want = _tensors(b.outputs), _tensors(a.outputs)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), f"dispatch {k}"
    for k, (a, b) in enumerate(zip(e_states, g_states)):
        assert torch.equal(a[0].surface, b[0].surface), f"surface after dispatch {k}"
        assert torch.equal(a[0].prev_ts, b[0].prev_ts), f"prev_ts after dispatch {k}"


@pytest.mark.chip
def test_nothing_handed_out_is_overwritten_by_a_later_replay(runs):
    _, (results, states, _, kept, _) = runs
    for k, r in enumerate(results):  # each dispatch's outputs as post copied them
        outs, copied = r.outputs[0], r.outputs[1]
        assert all(torch.equal(x, y) for x, y in zip(_tensors(outs), _tensors(copied))), k
    held, copied = kept["held"]
    assert held is states[HELD] and len(states) - HELD > 20
    assert all(torch.equal(x, y) for x, y in zip(held[0], copied))


@pytest.mark.chip
def test_launch_counters_count_the_eager_dispatches_and_the_captures(runs):
    """The counters count the launches the wrappers make: a capture's like
    an eager dispatch's, a replay none (it makes no launch of its own)."""
    (_, _, e_counts, _, _), (_, _, g_counts, _, _) = runs
    # K1 once an eager dispatch; past the first (the plan's C1 probe), the
    # same launches every dispatch
    assert all(c[0]["surface_scan_events"] == 1 for c in e_counts)
    assert all(c == e_counts[1] for c in e_counts[1:])
    none = [dict.fromkeys(c, 0) for c in e_counts[1]]
    for k, (e, g) in enumerate(zip(e_counts, g_counts)):
        assert g == (e if k in EAGER + CAPTURED else none), f"dispatch {k}"


@pytest.mark.chip
def test_the_graph_path_captures_each_key_once_and_replays_it(runs):
    """Captures: the first key's, the ultra wire's, and the first key's
    again after the weight moved (its version is part of every key); each
    new key's first dispatch runs eagerly."""
    (_, _, _, _, e_stats), (_, _, _, _, g_stats) = runs
    assert e_stats["eager_dispatches"] == DISPATCHES and e_stats["graph_replays"] == 0
    assert g_stats["graph_captures"] == len(CAPTURED)
    assert g_stats["eager_dispatches"] == len(EAGER)
    assert g_stats["graph_replays"] == DISPATCHES - len(EAGER)


def _kernel_counts(pipe, items):
    """Serve ``items`` under torch.profiler: each of KERNELS' launches by
    its kernels' records (each part of a name alike), or None where the
    trace holds unequal numbers of one launch's kernels (a lost record)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        list(pipe.serve(items))
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    counts = {}
    for launch, kernels in KERNELS.items():
        n = {sum(any(part in name for part in kernel.split("|")) for name in names)
             for kernel in kernels}
        if len(n) != 1:
            return None
        counts[launch] = n.pop()
    return counts


@pytest.mark.chip
@pytest.mark.parametrize("model", sorted(MODELS))
def test_a_replay_runs_the_kernels_of_an_eager_dispatch(card, model):
    """Every hand-written kernel on the path runs inside the graph: a trace
    of three replays holds K1's two kernels, K6, C1 and E1 three times as
    often as an eager dispatch launches them.  A trace can lose records;
    one that holds fewer is taken again, five at most, and one that holds
    more fails at once."""
    make, (h, w), _ = MODELS[model]
    net, params, post = make(card)
    items = _items(h, w)
    pipe = serving.StreamingPipeline(net, params, capacity=E, t_chunks=T, postprocess=post,
                                     device=card)
    list(pipe.serve(items[:2]))  # eager, the plan and its probe; a capture
    before = _launches()
    list(pipe.serve(items[2:3]))  # a replay
    after = _launches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serving, "graph_dispatch", lambda *args: False)
        eager = serving.StreamingPipeline(net, params, capacity=E, t_chunks=T,
                                          postprocess=post, device=card)
        list(eager.serve(items[:1]))
        ref = _launches()
        list(eager.serve(items[1:2]))
        per = {k: n - ref[i][k] for i, c in enumerate(_launches()) for k, n in c.items()
               if k in KERNELS}
    assert after == before and per["surface_scan_events"] == 1 and per["fused_stem"] == 1
    want = {k: 3 * n for k, n in per.items()}
    replays, got = pipe.stats["graph_replays"], []
    for attempt in range(5):
        k = 3 + 3 * attempt
        got.append(_kernel_counts(pipe, items[k:k + 3]))
        if got[-1] == want:
            break
        assert got[-1] is None or all(got[-1][n] <= want[n] for n in want), got
    assert got[-1] == want, f"traces {got}, an eager dispatch's launches {per}"
    assert pipe.stats["graph_replays"] == replays + 3 * len(got)
    assert pipe.stats["eager_dispatches"] == pipe.stats["graph_captures"] == 1


@pytest.mark.chip
def test_pipelines_that_share_a_network_replay_their_own_weights(card):
    """Two pipelines serve one network with other weight tensors, in turns:
    the second's eager dispatch packs C1's weights anew in the network's
    plan, yet the first's graph still reads its own, which it holds.  The
    memory the plan let go is refilled with NaN before the first replays
    again.  Each pipeline gives its eager pipeline's outputs bit for bit."""
    net, params_a, post = _efcn(card)
    params_b = {k: v * 1.25 for k, v in params_a.items()}
    items = _items(160, 224)[:8]
    pipes = [serving.StreamingPipeline(net, p, capacity=E, t_chunks=T, postprocess=post,
                                       device=card) for p in (params_a, params_b)]
    got = [[r.outputs for r in pipe.serve(items[:4])] for pipe in pipes]
    junk = [torch.full_like(t, float("nan")) for entry in conv_stack.held_weights(net)
            for t in _tensors(entry[2]) if torch.is_tensor(t) and t.is_cuda for _ in range(4)]
    for out, pipe in zip(got, pipes):
        out += [r.outputs for r in pipe.serve(items[4:])]
    del junk
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serving, "graph_dispatch", lambda *args: False)
        want = [[r.outputs for r in serving.StreamingPipeline(
            net, p, capacity=E, t_chunks=T, postprocess=post, device=card).serve(items)]
            for p in (params_a, params_b)]
    for pipe, g, e in zip(pipes, got, want):
        assert pipe.stats["graph_replays"] == 7 and pipe.stats["graph_captures"] == 1
        for k, (a, b) in enumerate(zip(g, e)):
            assert all(torch.equal(x, y) for x, y in zip(_tensors(a), _tensors(b))), k


def _rvt_b(card):
    text = open("async_ev_cnn_torch/configs/rvt_base_event.yml").read().split(
        "yolo_cnn_layers: ")[1].split("\n")[0]
    net = EventNetwork(layers_dict(text), 384, 640, 5e-5, 0.1, "SAME", conv_mode="full",
                       stem_fusion=False)
    wt = rvt_ref.make_weights(rvt_ref.architecture(), 2024, card)
    return net, fold_batchnorm(wt, eps=rvt_ref.BN_EPS, form="torch")


@pytest.mark.chip
@pytest.mark.parametrize("case", ["efcn_16_streams", "rvt_b_one_stream"])
def test_multi_stream_and_recurrent_pipelines_dispatch_eagerly(card, case):
    if case == "efcn_16_streams":
        net, params, _ = _efcn(card)
        streams, (h, w) = 16, (160, 224)
    else:
        (net, params), streams, (h, w) = _rvt_b(card), 1, (384, 640)
    pipe = serving.StreamingPipeline(net, params, capacity=E, t_chunks=4, streams=streams,
                                     device=card)
    rng = np.random.RandomState(7)
    items = [np.stack([rng.randint(0, h, 4 * E), rng.randint(0, w, 4 * E),
                       k * 4 * E + np.arange(4 * E)], axis=-1)
             for k in range(3) for _ in range(streams)]
    assert len(list(pipe.serve(items))) == 3
    assert pipe.stats["eager_dispatches"] == 3
    assert pipe.stats["graph_replays"] == pipe.stats["graph_captures"] == 0
