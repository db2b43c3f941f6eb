"""YOLOv3-tiny on the port's 'full' engine, held against the plain reference
(reference/yolov3_tiny.py) on the CPU at a small size: every width divided
by 16 (the heads keep 3 x (5 + 80) channels), a 64 x 64 surface, seeded
weights.

Tolerances: the port folds darknet's batch norm into the conv at load, so
each batch-normed layer rounds differently from the reference's unfolded
``(x - mean) / (sqrt(var) + eps) * gamma + beta`` by a few float32 ulps, and
the sums of the convs run in another order: grids, boxes and scores agree
to ``REL = 1e-5`` of their largest magnitude (the readings are 1e-6 to
2e-6).  Pools, routes, upsampling and the decode's arithmetic are exact.
The benchmark's cells run here too, through its harness at a tiny size,
sound and with the timed path broken.
"""

import json
import shutil
import time
from collections import Counter

import numpy as np
import pytest
import torch

from async_ev_cnn_torch.layers import network
from async_ev_cnn_torch.layers.network import EventNetwork, dense_forward
from async_ev_cnn_torch.layers.types import EventChunk
from async_ev_cnn_torch.models import head
from async_ev_cnn_torch.ops.integrate import integrate_parallel
from async_ev_cnn_torch.ops.pool import maxpool_dense
from async_ev_cnn_torch.utils import profiling
from async_ev_cnn_torch.utils.config import int_groups, layers_dict, layers_dsl
from async_ev_cnn_torch.utils.serving import StreamingPipeline
from async_ev_cnn_torch.utils.weights import fold_batchnorm
from portbench import work, work_graph
from reference import yolov3_tiny as ref

torch.set_num_threads(2)

REL = 1e-5
H = W = 64
DIV = 16
YAML = "async_ev_cnn_torch/configs/yolov3_tiny_event.yml"
EFCN = ("conv1=3,3,1,16 pool1=2,2 conv2=3,3,16,32 pool2=2,2 conv3=3,3,32,64 pool3=2,2 "
        "conv4=3,3,64,128 pool4=2,2 conv5=3,3,128,256 pool5=2,2 conv6=1,1,256,512 "
        "conv7=1,1,512,110")


def dsl_of(layers) -> str:
    """The reference's layer table in the port's DSL, darknet's indices as
    the names (a route to layer 19 names the upsample)."""
    parts = []
    for i, layer in enumerate(layers):
        kind = layer["kind"]
        if kind == "conv":
            k = layer["size"]
            parts.append(f"conv{i}={k},{k},{layer['in']},{layer['filters']}"
                         + ("" if layer["bn"] else "@linear"))
        elif kind == "maxpool":
            parts.append(f"pool{i}=2,2" + (",1" if layer["stride"] == 1 else ""))
        elif kind == "yolo":
            parts.append(f"yolo{i}=conv{i - 1}")
        elif kind == "route":
            parts.append(f"route{i}=" + ",".join(
                f"{'upsample' if layers[j]['kind'] == 'upsample' else 'conv'}{j}"
                for j in layer["layers"]))
        else:
            parts.append(f"upsample{i}={layer['stride']}")
    return " ".join(parts)


def darknet_weights(layers, seed=0) -> dict:
    """Seeded weights in darknet's form: He-normal kernels, batch-norm
    statistics (gamma and var in [0.5, 1.5), beta and mean N(0, 0.1^2)),
    the linear heads' biases."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, layer in enumerate(layers):
        if layer["kind"] != "conv":
            continue
        k, cin, cout = layer["size"], layer["in"], layer["filters"]
        out[f"w_conv{i}"] = torch.randn(cout, cin, k, k, generator=g) * (2 / (cin * k * k)) ** 0.5
        if layer["bn"]:
            for stat in ("gamma", "var"):
                out[f"{stat}_conv{i}"] = torch.rand(cout, generator=g) + 0.5
            for stat in ("beta", "mean"):
                out[f"{stat}_conv{i}"] = torch.randn(cout, generator=g) * 0.1
        else:
            out[f"b_conv{i}"] = torch.randn(cout, generator=g) * 0.1
    return out


LAYERS = ref.darknet_layers(div=DIV)
DSL = dsl_of(LAYERS)


def tiny_net(**kw) -> EventNetwork:
    return EventNetwork(layers_dict(DSL), H, W, 5e-5, 0.1, "SAME", conv_mode="full",
                        stem_fusion=False, **kw)


def surfaces(n=6, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, 1, H, W, generator=g) * (torch.rand(n, 1, H, W, generator=g) < 0.2)


def rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


# ---- the DSL --------------------------------------------------------------

@pytest.mark.parametrize("text", [
    DSL,
    open(YAML).read().split("yolo_cnn_layers: ")[1].split("\n")[0],
    "conv1=3,3,1,4@full@linear pool1=2,2,1 route2=conv1 upsample3=2 yolo4=conv1",
    "conv1=3,3,1,4@sparse pool1=2,2",
])
def test_the_dsl_round_trips_the_graph_tokens(text):
    d = layers_dict(text)
    assert layers_dsl(d) == text
    again = layers_dict(layers_dsl(d))
    assert list(again.items()) == list(d.items())
    assert again.modes == d.modes and again.linear == d.linear


def test_the_dsl_reads_names_and_suffixes():
    d = layers_dict("conv1=1,1,1,2@linear route2=upsample9,conv8 yolo3=conv1 pool4=2,2,1")
    assert d["route2"] == ["upsample9", "conv8"] and d["yolo3"] == ["conv1"]
    assert d["pool4"] == [2, 2, 1] and d.linear == {"conv1"} and d.modes == {}
    assert int_groups("10,14 23,27") == [[10, 14], [23, 27]]


@pytest.mark.parametrize("mode", ["dense", "sparse", "sparse_pallas", "sparse_rows", "window"])
@pytest.mark.parametrize("token", ["route3=conv1", "upsample3=2", "yolo3=conv1", "pool3=2,2,1",
                                   "conv3=1,1,4,4@linear"])
def test_the_incremental_modes_refuse_the_graph(mode, token):
    text = f"conv1=3,3,1,4 conv2=1,1,4,4 {token}"
    with pytest.raises(ValueError, match="need every layer 'full'"):
        EventNetwork(layers_dict(text), 16, 16, 1e-3, 0.1, "SAME", conv_mode=mode)
    # every layer 'full' takes it; the sequential engine still refuses it
    net = EventNetwork(layers_dict(text), 16, 16, 1e-3, 0.1, "SAME", conv_mode="full")
    assert net.is_graph
    with pytest.raises(ValueError, match="sequential engine runs a chain"):
        net.forward({}, net.init_state({}, "cpu"), None)


def test_a_route_must_name_earlier_layers_of_one_size():
    with pytest.raises(ValueError, match="no earlier layer"):
        EventNetwork(layers_dict("conv1=3,3,1,4 route2=conv9"), 16, 16, 1e-3, 0.1, "SAME",
                     conv_mode="full")
    with pytest.raises(ValueError, match="differ in size"):
        EventNetwork(layers_dict("conv1=3,3,1,4 pool2=2,2 route3=pool2,conv1"), 16, 16, 1e-3,
                     0.1, "SAME", conv_mode="full")


def test_the_published_network_builds_at_416():
    text = open(YAML).read().split("yolo_cnn_layers: ")[1].split("\n")[0]
    net = EventNetwork(layers_dict(text), 416, 416, 5e-5, 0.1, "SAME", conv_mode="full",
                       stem_fusion=False)
    shapes = {ld.name: ld.spec.out_shape for ld in net.event_layers}
    assert shapes["pool9"] == (256, 13, 13) and shapes["pool11"] == (512, 13, 13)
    assert shapes["conv8"] == (256, 26, 26)
    assert shapes["route20"] == (384, 26, 26) and shapes["yolo16"] == (255, 13, 13)
    assert shapes["yolo23"] == (255, 26, 26) and net.heads == ("yolo16", "yolo23")
    # E1 pools conv0/2/4/6; conv8's pair is not fused, a route reads conv8
    assert sorted(net._fused_pairs()) == [0, 2, 4, 6]
    assert text == dsl_of(ref.darknet_layers())
    n_params = sum(lay["in"] * lay["filters"] * lay["size"] ** 2 + lay["filters"]
                   * (4 if lay["bn"] else 1)
                   for lay in ref.darknet_layers() if lay["kind"] == "conv")
    # 8.85 M weights and biases; the batch norm's statistics fold into them
    assert 8.8e6 < n_params < 8.9e6


# ---- layers and load ----------------------------------------------------

@pytest.mark.parametrize("size", [13, 4, 7])
def test_the_same_stride_one_pool_is_darknets(size):
    x = torch.randn(3, 5, size, size) - 2.0  # negative maps: the padding must not win
    got = maxpool_dense(x, (2, 2), 1, "SAME")
    want = torch.nn.functional.max_pool2d(
        torch.nn.functional.pad(x, (0, 1, 0, 1), value=float("-inf")), 2, 1)
    assert got.shape == (3, 5, size, size) and torch.equal(got, want)


def test_fold_batchnorm_is_the_unfolded_batch_norm():
    layers = [dict(lay) for lay in LAYERS[:1]]
    w = darknet_weights(layers, seed=3)
    x = torch.randn(4, 1, 16, 16)
    folded = fold_batchnorm(w)
    assert set(folded) == {"w_conv0", "b_conv0"}
    got = torch.nn.functional.conv2d(x, folded["w_conv0"], padding=1) + folded[
        "b_conv0"].reshape(1, -1, 1, 1)
    raw = torch.nn.functional.conv2d(x, w["w_conv0"], padding=1)

    def c(name):
        return w[f"{name}_conv0"].reshape(1, -1, 1, 1)

    want = (raw - c("mean")) / (c("var").sqrt() + 1e-6) * c("gamma") + c("beta")
    assert rel(got, want) < REL
    # a dict without statistics comes back as it is
    plain = {"w_a": torch.ones(2, 1, 1, 1), "b_a": torch.zeros(2)}
    assert fold_batchnorm(plain).keys() == plain.keys()


def test_decode_yolov3_is_the_references():
    g = torch.Generator().manual_seed(5)
    heads = [torch.randn(2, 3, 2, 2, 255, generator=g), torch.randn(2, 3, 4, 4, 255, generator=g)]
    boxes, scores, probs = head.decode_yolov3(heads, ref.ANCHORS, ref.MASKS, H, W)
    want = ref.decode([h.reshape(6, *h.shape[2:]) for h in heads], ref.ANCHORS, ref.MASKS, H, W)
    assert boxes.shape == (2, 3, (4 + 16) * 3, 4) and probs.shape == (2, 3, 60, 80)
    for got, w in zip((boxes, scores, probs), want):
        assert rel(got.reshape(w.shape), w) < 1e-6


# ---- the engine ---------------------------------------------------------

def test_full_frame_forward_is_the_reference():
    net = tiny_net()
    w = darknet_weights(LAYERS)
    params = fold_batchnorm(w)
    x = surfaces()
    with profiling.recording():
        profiling.clear()
        got = net.full_frame_forward(params, net.init_state(params, "cpu"), x)
        names = Counter(s[0] for s in profiling.recorded())
    want = ref.forward(x, w, LAYERS)
    assert [g.shape for g in got] == [(6, 2, 2, 255), (6, 4, 4, 255)]
    for g, r in zip(got, want):
        assert rel(g, r) < REL
    # every layer has its span, but the pools that run in their conv's
    # pooled epilogue (and its span); four pooled epilogues, nine unpooled
    fused = {"pool1", "pool3", "pool5", "pool7"}
    assert all(names[f"layer.{ld.name}"] == (ld.name not in fused)
               for ld in net.event_layers[1:])
    assert names["conv.leaky"] == 13 and names["pool.max"] == 2


def test_the_walk_keeps_the_skip():
    net = tiny_net()
    params = fold_batchnorm(darknet_weights(LAYERS))
    x = surfaces()
    state = net.init_state(params, "cpu")
    before = net.full_frame_forward(params, state, x)
    # the layer before route20's input only: the skip's channels come after
    mid = net.full_frame_forward(params, state, x, upto=[ld.name for ld in
                                                        net.event_layers[1:]].index("route20"))
    assert mid.shape == (6, 8, 4, 4)
    assert not torch.equal(before[1], net.full_frame_forward(
        {**params, "w_conv8": params["w_conv8"] * 0.5}, state, x)[1])
    assert torch.equal(before[0], net.full_frame_forward(
        {**params, "w_conv21": params["w_conv21"] * 0.5}, state, x)[0])


def _chunks(s, t, e, seed=2):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, H, (s, t, e))
    x = rng.integers(0, W, (s, t, e))
    ts = np.cumsum(rng.integers(1, 9, (s, t * e)), axis=1).reshape(s, t, e)
    valid = np.ones((s, t, e), bool)
    valid[:, 1, e // 2:] = False
    return EventChunk(*(torch.from_numpy(a).int() for a in (y, x, ts)),
                      torch.zeros((s, t, e), dtype=torch.int32), torch.from_numpy(valid))


def test_scan_parallel_with_streams_is_the_reference():
    net = tiny_net()
    w = darknet_weights(LAYERS, seed=7)
    params = fold_batchnorm(w)
    chunks = _chunks(2, 4, 24)
    state = tuple(type(s)(*(f.expand(2, *f.shape).clone() for f in s))
                  for s in net.init_state(params, "cpu"))
    # windows of 3 then 1 chunk: the grids of each head are joined along time
    _, outs = net.scan_parallel(params, state, chunks, window=3)
    surf, _ = integrate_parallel(torch.zeros(2, 1, H, W), torch.zeros(2, dtype=torch.int32),
                                 chunks, 5e-5)
    want = ref.forward(surf.reshape(8, 1, H, W), w, LAYERS)
    assert [o.shape for o in outs] == [(2, 4, 2, 2, 255), (2, 4, 4, 4, 255)]
    for o, r in zip(outs, want):
        assert rel(o.reshape(r.shape), r) < REL


def test_the_pipeline_serves_both_heads_and_their_decode():
    net = tiny_net()
    w = darknet_weights(LAYERS, seed=8)
    params = fold_batchnorm(w)
    chunks = _chunks(2, 4, 16, seed=9)
    items = []
    for k in range(2):  # two dispatches of S = 2 streams x T = 4 chunks of 8 events
        for s in range(2):
            sl = slice(0, 8)
            ev = np.stack([chunks.y[s, :, sl].reshape(-1), chunks.x[s, :, sl].reshape(-1),
                           chunks.ts[s, :, sl].reshape(-1) + 10_000 * k], axis=1)
            items.append(ev.astype(np.int64))

    def post(outs):
        return outs, head.decode_yolov3(outs, ref.ANCHORS, ref.MASKS, H, W)

    pipe = StreamingPipeline(net, params, capacity=8, streams=2, t_chunks=4,
                             postprocess=post, device="cpu")
    results = list(pipe.serve(items))
    assert len(results) == 2
    surf, prev = torch.zeros(2, 1, H, W), torch.zeros(2, dtype=torch.int32)
    for k, res in enumerate(results):
        grids, (boxes, _, probs) = res.outputs
        group = items[2 * k:2 * k + 2]
        c = EventChunk(*(torch.from_numpy(np.stack([g[:, i] for g in group])).int().reshape(2, 4, 8)
                         for i in range(3)), torch.zeros(2, 4, 8, dtype=torch.int32),
                       torch.ones(2, 4, 8, dtype=torch.bool))
        frames, last = integrate_parallel(surf, prev, c, 5e-5)
        surf, prev = frames[:, -1], last[:, -1]
        want = ref.forward(frames.reshape(8, 1, H, W), w, LAYERS)
        for g, r in zip(grids, want):
            assert rel(g.reshape(r.shape), r) < REL
        want_boxes, _, want_probs = ref.decode(want, ref.ANCHORS, ref.MASKS, H, W)
        assert rel(boxes.reshape(want_boxes.shape), want_boxes) < REL
        assert rel(probs.reshape(want_probs.shape), want_probs) < REL
    assert torch.equal(pipe.state[0].surface, surf)


def test_the_memory_model_counts_the_kept_maps():
    # conv1's 8 x 16 x 16 map is kept for route4: 2,048 floats live beside
    # every later pair.  Per layer, input (unless kept) + output + kept:
    # conv1 256 + 2048; conv2 0 + 256 + 2048; conv3 256 + 256 + 2048;
    # route4 0 + 2304 + 2304 (conv1 and conv3 kept), the peak
    net = EventNetwork(layers_dict("conv1=3,3,1,8 conv2=1,1,8,1 conv3=1,1,1,1 route4=conv3,conv1"),
                       16, 16, 1e-3, 0.1, "SAME", conv_mode="full")
    assert net.parallel_live_bytes_per_chunk() == 4 * (2 * 256 + 4608)
    # the adjacent pairs alone would read 2,304 + 256
    assert net.auto_window(64, 4 * (2 * 256 + 4608) * 2 * 8 / 2**20) == 8
    # YOLOv3-tiny at conv21: its input (route20), its output and the maps
    # kept to the walk's end, conv8, conv13, conv15 (head 1), upsample19
    tiny = tiny_net()
    by = {ld.name: int(np.prod(ld.spec.out_shape)) for ld in tiny.event_layers[1:]}
    at_conv21 = sum(by[n] for n in ("route20", "conv21", "conv8", "conv13", "conv15",
                                    "upsample19"))
    assert tiny.parallel_live_bytes_per_chunk() >= 4 * (2 * H * W + at_conv21)
    # a chain network's model is the widest adjacent pair, as before
    efcn = EventNetwork(layers_dict(EFCN), 160, 224, 5e-5, 0.1, "SAME", conv_mode="full")
    outs = [160 * 224] + [int(np.prod(ld.spec.out_shape)) for ld in efcn.event_layers[1:]]
    assert efcn.parallel_live_bytes_per_chunk() == 4 * (
        2 * 160 * 224 + max(a + b for a, b in zip(outs, outs[1:])))


def test_the_graph_shape_walk_counts_the_flops():
    efcn = json.loads(open("portbench/configs/efcn_full.json").read())
    assert work_graph.frame_flops(efcn["layers"], 160, 224) == work.frame_flops(
        efcn["layers"], 160, 224) == 353_740_800
    yolo = json.loads(open("portbench/configs/yolov3tiny_full.json").read())
    assert work_graph.frame_flops(yolo["layers"], 416, 416) == 5_465_281_536
    assert work_graph.frame_flops(dict(layers_dict(DSL)), H, W) == sum(
        2 * ld.spec.out_shape[1] * ld.spec.out_shape[2] * ld.spec.in_shape[0]
        * ld.spec.out_channels * ld.spec.ksize[0] * ld.spec.ksize[1]
        for ld in tiny_net().event_layers if ld.kind == "conv")


# ---- the shared path: the eFCN's walk is unchanged --------------------------

def test_the_efcn_walk_is_unchanged():
    net = EventNetwork(layers_dict(EFCN), 32, 32, 5e-5, 0.1, "SAME", conv_mode="full")
    g = torch.Generator().manual_seed(4)
    params = {}
    for ld in net.event_layers:
        if ld.kind == "conv":
            cin, (kh, kw), cout = ld.spec.in_shape[0], ld.spec.ksize, ld.spec.out_channels
            params[f"w_{ld.name}"] = torch.randn(cout, cin, kh, kw, generator=g) * 0.1
            params[f"b_{ld.name}"] = torch.randn(cout, generator=g) * 0.1
    frames = torch.rand(3, 1, 32, 32, generator=g)
    state = net.init_state(params, "cpu")
    with profiling.recording():
        profiling.clear()
        out = net.full_frame_forward(params, state, frames)
        spans = [s[0] for s in sorted(profiling.recorded(), key=lambda s: s[1])]
    assert not net.is_graph and isinstance(out, torch.Tensor)
    # seven epilogues (conv.leaky), five of them pooled: no pool.max span
    assert Counter(spans)["conv.leaky"] == 7 and "pool.max" not in spans
    assert spans == ["scan.conv_stack"] + [
        x for k in range(1, 8) for x in (f"layer.conv{k}", "conv.gemm", "conv.leaky")] + [
        "layer.tail"]
    want = dense_forward(net.event_layers, params, frames)["conv7"].movedim(-3, -1)
    assert torch.equal(out, want)


# ---- the serve CLI --------------------------------------------------------

def test_the_serve_cli_runs_the_yolo_yaml_with_out(tmp_path, rng):
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
    np.savez(str(root / "params.npz"), num_classes=80,
             label_to_idx=np.array([(f"c{i}", i) for i in range(80)], dtype=object))
    # a darknet-form checkpoint: HWIO kernels, batch-norm statistics
    ckpt = tmp_path / "weights.npz"
    save_params(str(ckpt), {k: (v.permute(2, 3, 1, 0) if k.startswith("w_") else v).numpy()
                            for k, v in darknet_weights(LAYERS, seed=11).items()})
    out = tmp_path / "dets.jsonl"
    stats = serve.main([
        "--device", "cpu", "-c", YAML, "--input_data_dir", str(root),
        "--restore_net", str(ckpt), "--frame_h", str(H), "--frame_w", str(W),
        "--example_h", str(H), "--example_w", str(W), "--yolo_cnn_layers", DSL,
        "--batch_event_size", "50", "--serve_chunks", "8", "--num_streams", "2",
        "--out", str(out), "--conf_threshold", "0.3"])
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert stats["dispatches"] >= 1 and stats["detections_written"] == len(lines) > 0
    assert all(0 <= d["class"] < 80 and len(d["bbox_xywh"]) == 4 and d["score"] >= 0.3
               for d in lines)


@pytest.mark.parametrize("streams", [1, 2])
def test_write_detections_counts_its_rows_in_a_serve_out_span(tmp_path, streams):
    from types import SimpleNamespace

    from async_ev_cnn_torch.scripts import serve

    g = torch.Generator().manual_seed(3)
    lead = (streams, 3) if streams > 1 else (3,)
    centres = torch.rand(*lead, 6, 2, generator=g) * 60
    boxes = torch.cat([centres, torch.full((*lead, 6, 2), 8.0)], dim=-1)
    boxes[..., 1, :2] = boxes[..., 0, :2] + 1  # box 1 overlaps box 0 by an IoU of 0.6
    boxes[..., 2, 0] = boxes[..., 0, 0] + 20  # box 2 is apart from box 0
    probs = torch.rand(*lead, 6, 4, generator=g) * 0.2
    probs[..., :2, 0] = torch.tensor([0.9, 0.8])  # box 0 kept, box 1 suppressed
    probs[..., 2, 1] = 0.5  # kept
    counts = np.full(lead, 50)
    counts[..., -1] = 0  # a padding chunk writes nothing
    res = SimpleNamespace(outputs=(boxes, probs), counts=counts)
    out = tmp_path / "dets.jsonl"
    profiling.clear()
    with out.open("w") as fh, profiling.recording():
        n = serve._write_detections(fh, res, SimpleNamespace(conf_threshold=0.3), 7, streams)
        spans = profiling.recorded()
    profiling.clear()
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert n == len(lines) == 2 * 2 * streams
    assert Counter((d["stream"], d["chunk"]) for d in lines) == {
        (s, t): 2 for s in range(streams) for t in range(2)}
    assert [(d["class"], d["score"]) for d in lines[:2]] == [(0, 0.9), (1, 0.5)]
    assert [(s[0], s[4]) for s in spans] == [("serve.out", 7)]


# ---- the benchmark's new cells at a tiny size -------------------------------

def tiny_bench(dest):
    """A checkout-like root: the benchmark's files and a tiny YOLOv3-tiny
    cell (the widths of this file, 64 x 64), with the repo's metrics of it."""
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    shutil.copytree(repo / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = dest / "portbench"
    yolo = json.loads((pb / "configs" / "yolov3tiny_full.json").read_text())
    d = layers_dict(DSL)
    yolo.update(frame_h=H, frame_w=W, layers={k: v for k, v in d.items()},
                linear=sorted(d.linear), serve_chunks=4, events_per_chunk=16)
    (pb / "configs" / "tiny_yolo.json").write_text(json.dumps(yolo))
    (pb / "traffic" / "tiny_replay.json").write_text(json.dumps(
        {"loop": "closed", "streams": 2, "chunks": 4, "events_per_chunk": 16,
         "pixels": "clustered", "radius": 3, "ts_gap_us": [1, 14], "pool": 3,
         "warmup_requests": 2}))
    # the program agrees to the folding's rounding (readings to 3e-5);
    # bfloat16 surfaces are off by their 8-bit mantissa
    limits = {"out_gap": {"limit": 1e-4}, "surface_gap": {"limit": 1e-6}}
    (pb / "limits" / "t.yolo.json").write_text(json.dumps(limits))
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    stands = {"yolov3tiny_full.replay_s16": "t.yolo"}
    bench["configs"] = [{"name": c, "source": "tests", "file": f"portbench/configs/{c}.json",
                         "reduced": [], "why": "tiny"} for c in ("tiny_yolo",)]
    bench["workloads"] = [{"name": "t.yolo", "config": "tiny_yolo", "traffic": "tiny_replay",
                           "chips": 1, "why": "tiny"}]
    for section in ("end_to_end", "per_layer"):
        bench[section] = [dict(m, workloads=[stands[w] for w in m["workloads"] if w in stands])
                          if "workloads" in m else m for m in bench[section]]
        bench[section] = [m for m in bench[section] if m.get("workloads", [1])]
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


def _run(root, cell, trace=False):
    from portbench.run import run_cell

    return run_cell(root, cell, 2**31 + 91, 0.5, trace, "cpu", t0=time.perf_counter())


@pytest.mark.parametrize("cell", ["t.yolo"])
def test_a_tiny_run_of_each_new_cell_is_correct(tmp_path, cell):
    root = tiny_bench(tmp_path)
    result, lines = _run(root, cell)
    assert result["correct"], lines
    assert set(result["metrics"]) == {"events_per_s", "setup_s"}
    assert result["attempted"] > 0 and result["failed"] == 0
    traced, lines = _run(root, cell, trace=True)
    assert traced["correct"], lines
    m = traced["metrics"]
    # a CPU run reads no device metric
    assert set(m) == {"mfu.y3t"}


def test_the_yolo_cell_with_the_skip_zeroed_is_not_correct(tmp_path, monkeypatch):
    root = tiny_bench(tmp_path)
    route = network.route

    def no_skip(parts):  # conv8's skip into route20 replaced by zeros
        if len(parts) == 2:
            parts = [parts[0], torch.zeros_like(parts[1])]
        return route(parts)

    monkeypatch.setattr(network, "route", no_skip)
    result, lines = _run(root, "t.yolo")
    assert not result["correct"], lines
    assert result["checks"]["out_gap"]["value"] > 1e-3


def _no_centre_sigmoid(decode):
    """``decode_yolov3`` with each centre offset the raw logit, not its
    sigmoid."""
    def decoded(grids, anchors, masks, h_image, w_image):
        boxes, obj, probs = decode(grids, anchors, masks, h_image, w_image)
        shift = []
        for g, mask in zip(grids, masks):
            gh, gw = g.shape[-3:-1]
            t = g.reshape(*g.shape[:-1], len(mask), -1)[..., :2].float()
            d = (t - torch.sigmoid(t)) * torch.tensor([w_image / gw, h_image / gh])
            shift.append(d.reshape(*g.shape[:-3], -1, 2))
        return torch.cat([boxes[..., :2] + torch.cat(shift, dim=-2), boxes[..., 2:]], -1), \
            obj, probs
    return decoded


def _row_for_column(decode):
    """``decode_yolov3`` with each box's centre x and y exchanged."""
    def decoded(*args):
        boxes, obj, probs = decode(*args)
        return boxes[..., [1, 0, 2, 3]], obj, probs
    return decoded


@pytest.mark.parametrize("fault", [_row_for_column, _no_centre_sigmoid])
def test_the_yolo_cell_with_a_centre_decode_fault_is_not_correct(tmp_path, monkeypatch,
                                                                 fault):
    root = tiny_bench(tmp_path)
    monkeypatch.setattr(head, "decode_yolov3", fault(head.decode_yolov3))
    result, lines = _run(root, "t.yolo")
    assert not result["correct"], lines
    assert result["checks"]["out_gap"]["value"] > 1e-3
