"""The port's serve CLI (async_ev_cnn_torch/scripts/serve.py) held against
the JAX package's (async_ev_cnn_tpu/scripts/serve.py) on a synthetic
n-data detection tree written under ``tmp_path`` (as tests/test_cli.py
writes its own), with the same seeded checkpoint.

Tolerances: the detections' boxes agree to 1e-3 px and their scores to
1e-3 (the JSONL rounds boxes to 0.01 px and scores to 1e-4; the networks
differ by float32 sums in another order, ~1e-6), with the same dispatch,
stream, chunk and class on every line and the same number of lines; the
events, dispatches and wire bytes are exact.  A stop and resume through
``--serve_state`` is held bit for bit against the same pipeline run
without the stop.
"""

import json

import numpy as np
import pytest
import torch

from async_ev_cnn_torch.data.file_reader import NReader
from async_ev_cnn_torch.scripts import serve as tserve
from async_ev_cnn_torch.utils.checkpoint import restore_stream_state, save_params
from async_ev_cnn_tpu.scripts import serve as jserve

torch.set_num_threads(2)

BOX_TOL = 1e-3
SCORE_TOL = 1e-3
LAYERS = "conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,8 pool2=2,2 conv3=1,1,8,13"


@pytest.fixture
def tree(tmp_path, rng):
    """Four test examples of 300 events (and a train and a validation one),
    annotations and params.npz, written by the port's NReader; a seeded
    checkpoint; the YAML config both CLIs read."""
    reader = NReader()
    root = tmp_path / "det"
    (root / "annotations").mkdir(parents=True)
    for split, k in (("train", 1), ("test", 4), ("validation", 1)):
        (root / split).mkdir()
        for i in range(k):
            n = 300
            x = rng.randint(0, 24, n).astype(np.int32)
            y = rng.randint(0, 20, n).astype(np.int32)
            ts = np.sort(rng.randint(0, 60000, n)).astype(np.int32)
            p = rng.randint(0, 2, n).astype(np.int32)
            name = f"{split}_ex{i}"
            reader.save_example(str(root / split / f"{name}.bin"), x, y, ts, p)
            np.save(str(root / "annotations" / f"{name}.npy"), rng.rand(1, 6).astype(np.float32))
    np.savez(str(root / "params.npz"), num_classes=3,
             label_to_idx=np.array([("a", 0), ("b", 1), ("c", 2)], dtype=object))
    params = {}
    for name, (kh, kw, ci, co) in (("conv1", (3, 3, 1, 4)), ("conv2", (3, 3, 4, 8)),
                                   ("conv3", (1, 1, 8, 13))):
        params[f"w_{name}"] = rng.randn(kh, kw, ci, co).astype(np.float32) * 0.2
        params[f"b_{name}"] = rng.randn(co).astype(np.float32) * 0.1
    ckpt = tmp_path / "weights.npz"
    save_params(str(ckpt), params)
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(
        f"input_data_dir: {root}\nfile_format: n-data\nnetwork: YoloEventJax\n"
        f"restore_net: {ckpt}\nleak: 1.0e-04\nbatch_size: 1\nbatch_event_size: 100\n"
        "frame_h: 16\nframe_w: 20\nexample_h: 20\nexample_w: 24\n"
        f"yolo_cnn_layers: {LAYERS}\nyolo_cnn_padding: SAME\n"
        "yolo_num_cells_h: 4\nyolo_num_cells_w: 5\nyolo_num_bbox: 2\n")
    return cfg


def _lines(path):
    return _lines_of(path.read_text().splitlines())


def _assert_same_detections(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["dispatch"], g["stream"], g["chunk"], g["class"]) == (
            w["dispatch"], w["stream"], w["chunk"], w["class"])
        np.testing.assert_allclose(g["bbox_xywh"], w["bbox_xywh"], rtol=0, atol=BOX_TOL + 0.01)
        assert abs(g["score"] - w["score"]) <= SCORE_TOL


@pytest.mark.parametrize("streams,wire", [(1, "auto"), (4, "auto"), (2, "plain")])
def test_serve_cli_matches_jax(tmp_path, tree, streams, wire):
    """Both CLIs serve the test split as ``streams`` feeds, two chunks a
    dispatch, with --out: the same detections (host NMS of the decoded
    head), events, dispatches and wire bytes; the port on the CPU."""
    common = ["-c", str(tree), "--mode", "full", "--serve_chunks", "2",
              "--num_streams", str(streams), "--serve_wire", wire,
              "--conf_threshold", "-10.0"]
    t_out, j_out = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    t_stats = tserve.main(common + ["--out", str(t_out), "--device", "cpu"])
    j_stats = jserve.main(common + ["--out", str(j_out)])
    _assert_same_detections(_lines(t_out), _lines(j_out))
    for key in ("dispatches", "streams", "events", "detections_written", "wire_bytes",
                "wire_B_per_event", "state_restored", "rebased_epochs_us"):
        assert t_stats[key] == j_stats[key], key
    assert t_stats["device"] == "cpu"
    assert t_stats["dispatches"] >= 2
    assert t_stats["wire_tier"] in ("ultra4", "ultra", "compact", "plain")


def test_serve_cli_state_stop_and_resume(tmp_path, tree):
    """--serve_state: a run stopped after one dispatch writes its state, a
    second run restores it (the source restarts at the split's head, as in
    the JAX CLI) and appends.  The resumed run's detections and final
    state are bit-equal to one pipeline that serves the split twice without
    a stop (a run enqueues every dispatch of the split before its first one
    retires, as in the JAX CLI, so the state it saves is the split's end);
    the JAX CLI, stopped and resumed the same way, writes the same
    detections."""
    from async_ev_cnn_torch.data import detection_reader
    from async_ev_cnn_torch.models.yolo import YoloEventTorch
    from async_ev_cnn_torch.utils.config import config
    from async_ev_cnn_torch.utils.serving import StreamingPipeline

    base = ["-c", str(tree), "--mode", "full", "--serve_chunks", "2", "--num_streams", "2",
            "--serve_max_dispatches", "1", "--conf_threshold", "-10.0"]
    out, st = tmp_path / "t.jsonl", tmp_path / "state.npz"
    run = base + ["--serve_state", str(st), "--out", str(out), "--device", "cpu"]
    assert tserve.main(run)["state_restored"] is False
    first = out.read_text().splitlines()
    assert tserve.main(run)["state_restored"] is True
    lines = out.read_text().splitlines()
    assert lines[:len(first)] == first and len(lines) > len(first)

    # the same pipeline without a stop: the split's items twice
    from async_ev_cnn_torch.models import head

    args = config(base)
    reader = detection_reader.factory(args.input_data_dir, file_format=args.file_format)
    model = YoloEventTorch(
        h_frame=16, w_frame=20, num_classes=3, cnn_layers=args.yolo_cnn_layers,
        cnn_padding="SAME", h_cells=4, w_cells=5, num_bbox=2, alpha=0.1, leak=args.leak,
        checkpoint=args.restore_net, conv_mode="full", device="cpu")

    def post(outs):  # the CLI's: decoded boxes and class probs
        boxes, _, probs = head.decode(outs, 3, 2, 16, 20)
        return boxes, probs

    pipe = StreamingPipeline(model.net, model.params, capacity=100, streams=2, t_chunks=2,
                             postprocess=post, device="cpu")
    items = [ev for _, ev in tserve._stream_items(reader, args, 2, 100, 2)]
    results = list(pipe.serve(items + items))
    ref = tmp_path / "ref.jsonl"
    with open(ref, "w") as fh:
        tserve._write_detections(fh, results[len(items) // 2], args, 0, 2)
    assert lines[len(first):] == ref.read_text().splitlines()
    for a, b in zip(restore_stream_state(str(st), pipe.state), pipe.state):
        for fa, fb in zip(a, b):
            assert fa.dtype == fb.dtype and torch.equal(fa, fb)

    j_out, j_st = tmp_path / "j.jsonl", tmp_path / "j_state.npz"
    j_run = base + ["--serve_state", str(j_st), "--out", str(j_out)]
    jserve.main(j_run)
    jserve.main(j_run)
    _assert_same_detections(_lines_of(lines), _lines_of(j_out.read_text().splitlines()))
    with pytest.raises(ValueError, match="leaves|shape"):
        tserve.main(run[:-2] + ["--num_streams", "3", "--device", "cpu"])


def _lines_of(raw):
    return sorted((json.loads(x) for x in raw),
                  key=lambda r: (r["dispatch"], r["stream"], r["chunk"], r["class"],
                                 r["bbox_xywh"]))


def test_serve_cli_refusals(tmp_path, tree):
    """As the JAX CLI: incremental modes and a one-channel net under
    --keep_polarity are refused; without --device and without a card the
    port raises instead of running on the CPU."""
    with pytest.raises(SystemExit, match="full"):
        tserve.main(["-c", str(tree), "--mode", "dense", "--device", "cpu"])
    with pytest.raises(SystemExit, match="in_channels must be 2"):
        tserve.main(["-c", str(tree), "--mode", "full", "--keep_polarity", "true",
                     "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.main(["-c", str(tree), "--mode", "full"])
