"""The port's train, evaluate and run_networks CLIs
(async_ev_cnn_torch/scripts/) held against the JAX package's
(async_ev_cnn_tpu/scripts/) on synthetic n-data trees written under
``tmp_path``, the trees and configs copied from tests/test_train_cli.py
and tests/test_cli.py.

Tolerances:
* the train CLI's seeded initialisation: bit for bit;
* 10 train CLI steps against the JAX CLI's 10 on the same tree: the
  weights within 1e-5 absolute (the learning rate is 3e-3: a three
  hundredth of one step; torch.optim.Adam rounds otherwise than optax),
  the final loss within 1e-4 relative;
* a run that stops and resumes in the other package: within the same
  tolerance of that package's uninterrupted run; a stop and resume within
  the port: bit for bit;
* evaluate: the JSON line equal to the JAX CLI's, each example's grid
  within 1e-5 and its decoded scores within 1e-5 of JAX's;
* run_networks: the same step and example counts as the JAX CLI's (its
  outputs are timings).
"""

import json

import numpy as np
import pytest
import torch

from async_ev_cnn_torch.data.file_reader import NReader
from async_ev_cnn_torch.scripts import evaluate as teval
from async_ev_cnn_torch.scripts import run_networks as trun
from async_ev_cnn_torch.scripts import train as ttrain
from async_ev_cnn_torch.utils import checkpoint as tck
from async_ev_cnn_torch.utils.config import layers_dict
from async_ev_cnn_tpu.scripts import evaluate as jeval
from async_ev_cnn_tpu.scripts import run_networks as jrun
from async_ev_cnn_tpu.scripts import train as jtrain

torch.set_num_threads(2)

STEP_ATOL = 1e-5
LOSS_RTOL = 1e-4
GRID_TOL = 1e-5
SCORE_TOL = 1e-5
CPU = ["--device", "cpu"]
LEARN_LAYERS = "conv1=3,3,1,8 pool1=2,2 conv2=3,3,8,16 pool2=2,2 conv3=1,1,16,12"
# the same stack with an fc tail onto the 4x4 grid of 2 classes, 2 boxes
FC_LAYERS = ("conv1=3,3,1,8 pool1=2,2 conv2=3,3,8,16 pool2=2,2 conv3=1,1,16,8 "
             "flatten1= fc1=128,192")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _quiet(main, argv):
    """A CLI's ``main`` with its per-step lines dropped."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


@pytest.fixture
def learnable_detection_root(tmp_path, rng):
    """Events cluster on an 'object' whose quadrant determines its class."""
    return _write_learnable_tree(tmp_path / "det", rng)


def _write_learnable_tree(root, rng):
    reader = NReader()
    (root / "annotations").mkdir(parents=True)
    h = w = 16
    for split, k in (("train", 24), ("test", 8), ("validation", 2)):
        d = root / split
        d.mkdir()
        for i in range(k):
            cls = i % 2
            cy, cx = (4, 4) if cls == 0 else (12, 12)
            n = 400
            y = np.clip(cy + (rng.randn(n) * 1.5).astype(int), 0, h - 1)
            x = np.clip(cx + (rng.randn(n) * 1.5).astype(int), 0, w - 1)
            ts = np.sort(rng.randint(0, 50000, n))
            p = rng.randint(0, 2, n)
            name = f"{split}_{i}"
            reader.save_example(str(d / f"{name}.bin"), x, y, ts, p)
            box = np.array([[cx / w, cy / h, 6 / w, 6 / h, cls, 0]], np.float32)
            np.save(str(root / "annotations" / f"{name}.npy"), box)
    np.savez(str(root / "params.npz"), num_classes=2,
             label_to_idx=np.array([("a", 0), ("b", 1)], dtype=object))
    return root


@pytest.fixture
def constant_detection_root(tmp_path, rng):
    """Every train example identical: a resumed run then repeats the
    uninterrupted one whatever the reader's cursor."""
    reader = NReader()
    root = tmp_path / "det_const"
    (root / "annotations").mkdir(parents=True)
    h = w = 16
    n = 400
    y = np.clip(4 + (rng.randn(n) * 1.5).astype(int), 0, h - 1)
    x = np.clip(4 + (rng.randn(n) * 1.5).astype(int), 0, w - 1)
    ts = np.sort(rng.randint(0, 50000, n))
    p = rng.randint(0, 2, n)
    box = np.array([[4 / w, 4 / h, 6 / w, 6 / h, 0, 0]], np.float32)
    for split, k in (("train", 8), ("test", 2), ("validation", 2)):
        d = root / split
        d.mkdir()
        for i in range(k):
            name = f"{split}_{i}"
            reader.save_example(str(d / f"{name}.bin"), x, y, ts, p)
            np.save(str(root / "annotations" / f"{name}.npy"), box)
    np.savez(str(root / "params.npz"), num_classes=2,
             label_to_idx=np.array([("a", 0), ("b", 1)], dtype=object))
    return root


def _cfg(tmp_path, root, ckpt, layers=LEARN_LAYERS):
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(
        f"input_data_dir: {root}\nfile_format: n-data\nnetwork: YoloEventJax\n"
        f"restore_net: {ckpt}\nleak: 1.0e-05\nbatch_size: 4\n"
        "batch_event_size: 200\nframe_h: 16\nframe_w: 16\n"
        "example_h: 16\nexample_w: 16\n"
        f"yolo_cnn_layers: {layers}\n"
        "yolo_cnn_padding: SAME\nyolo_num_cells_h: 4\nyolo_num_cells_w: 4\n"
        "yolo_num_bbox: 2\n"
    )
    return cfg


# ---- train ---------------------------------------------------------------------


@pytest.mark.parametrize("layers", [LEARN_LAYERS, FC_LAYERS], ids=["conv", "fc"])
def test_train_cli_init_is_the_jax_clis_bit_for_bit(tmp_path, learnable_detection_root, layers):
    """The seeded He-normal init: ``init_params`` against the checkpoint
    the JAX CLI writes after one step at learning rate 0 (Adam's update
    times -0.0 leaves every weight as it was), and the port CLI's own such
    checkpoint against both."""
    cfg = _cfg(tmp_path, learnable_detection_root, "unused", layers)
    paths = {}
    for name, main, extra in (("jax", jtrain.main, []), ("torch", ttrain.main, CPU)):
        paths[name] = str(tmp_path / f"{name}.npz")
        _quiet(main, ["-c", str(cfg), "--train_steps", "1", "--learning_rate", "0",
                      "--save_to", paths[name]] + extra)
    want = tck.load_params(paths["jax"])
    init = ttrain.init_params(layers_dict(layers))
    got = tck.load_params(paths["torch"])
    assert sorted(init) == sorted(want) == sorted(got)
    for k in want:
        assert init[k].dtype == np.float32
        np.testing.assert_array_equal(_bits(init[k]), _bits(want[k]), err_msg=k)
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)


def _train_both(tmp_path, cfg, steps, extra=()):
    """The JAX CLI and the port's on the same tree and config; their
    checkpoints, optimizer states and final losses."""
    out = {}
    for name, main, dev in (("jax", jtrain.main, []), ("torch", ttrain.main, CPU)):
        ckpt = str(tmp_path / f"{name}.npz")
        loss = _quiet(main, ["-c", str(cfg), "--train_steps", str(steps), "--learning_rate",
                             "3e-3", "--save_to", ckpt, *extra] + dev)
        with np.load(ttrain.opt_state_path(ckpt)) as z:
            opt = {k: z[k] for k in z.files}
        out[name] = (tck.load_params(ckpt), opt, loss)
    return out


def _assert_close_runs(got, want):
    (gp, gopt, gloss), (wp, wopt, wloss) = got, want
    np.testing.assert_allclose(gloss, wloss, rtol=LOSS_RTOL)
    assert sorted(gp) == sorted(wp)
    for k in wp:
        np.testing.assert_allclose(gp[k], wp[k], rtol=0, atol=STEP_ATOL, err_msg=k)
    assert sorted(gopt) == sorted(wopt)
    assert gopt["leaf_0"].dtype == np.int32 and gopt["leaf_0"] == wopt["leaf_0"]
    for k in wopt:
        assert gopt[k].shape == wopt[k].shape and gopt[k].dtype == wopt[k].dtype, k


def test_ten_train_cli_steps_match_jax(tmp_path, learnable_detection_root):
    cfg = _cfg(tmp_path, learnable_detection_root, "unused")
    runs = _train_both(tmp_path, cfg, 10)
    _assert_close_runs(runs["torch"], runs["jax"])
    assert runs["torch"][2] < 10.0  # it trained: the first loss is ~ 18


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_a_run_resumes_in_the_other_package(tmp_path, constant_detection_root, first):
    """4 steps in one package, then ``--resume_from`` its .npz and .opt.npz
    for 4 more in the other: within the tolerance of 8 uninterrupted steps
    of the second package, and not what a moment restart gives."""
    cfg = _cfg(tmp_path, constant_detection_root, "unused")
    mains = {"jax": (jtrain.main, []), "torch": (ttrain.main, CPU)}
    second = "torch" if first == "jax" else "jax"
    run = ["-c", str(cfg), "--learning_rate", "3e-3"]
    full = str(tmp_path / "full.npz")
    full_loss = _quiet(mains[second][0],
                       run + ["--train_steps", "8", "--save_to", full] + mains[second][1])
    mid = str(tmp_path / "mid.npz")
    _quiet(mains[first][0], run + ["--train_steps", "4", "--save_to", mid] + mains[first][1])
    res = str(tmp_path / "res.npz")
    res_loss = _quiet(mains[second][0], run + ["--train_steps", "4", "--resume_from", mid,
                                               "--save_to", res] + mains[second][1])
    np.testing.assert_allclose(res_loss, full_loss, rtol=LOSS_RTOL)
    want, got = tck.load_params(full), tck.load_params(res)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=STEP_ATOL, err_msg=k)
    with np.load(ttrain.opt_state_path(res)) as z:
        assert int(z["leaf_0"]) == 8


def test_train_cli_resume_is_bit_for_bit(tmp_path, constant_detection_root):
    """The JAX package's resume test in the port: 8 steps == 4 + resume + 4
    bit for bit, and dropping the .opt.npz diverges."""
    import os

    root = constant_detection_root
    cfg = _cfg(tmp_path, root, "unused")
    run = ["-c", str(cfg), "--learning_rate", "3e-3"] + CPU
    full_ckpt = str(tmp_path / "full.npz")
    _quiet(ttrain.main, run + ["--train_steps", "8", "--save_to", full_ckpt])
    full = tck.load_params(full_ckpt)
    mid_ckpt = str(tmp_path / "mid.npz")
    _quiet(ttrain.main, run + ["--train_steps", "4", "--save_to", mid_ckpt])
    assert os.path.exists(ttrain.opt_state_path(mid_ckpt))
    res_ckpt = str(tmp_path / "res.npz")
    _quiet(ttrain.main, run + ["--train_steps", "4", "--resume_from", mid_ckpt,
                               "--save_to", res_ckpt])
    resumed = tck.load_params(res_ckpt)
    assert set(resumed) == set(full)
    for k in full:
        np.testing.assert_array_equal(_bits(resumed[k]), _bits(full[k]), err_msg=k)
    with np.load(ttrain.opt_state_path(res_ckpt)) as a, \
            np.load(ttrain.opt_state_path(full_ckpt)) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), err_msg=k)
    os.remove(ttrain.opt_state_path(mid_ckpt))
    cold_ckpt = str(tmp_path / "cold.npz")
    _quiet(ttrain.main, run + ["--train_steps", "4", "--resume_from", mid_ckpt,
                               "--save_to", cold_ckpt])
    cold = tck.load_params(cold_ckpt)
    assert any(not np.array_equal(cold[k], full[k]) for k in full)


def test_train_cli_checkpoint_every_and_resume(tmp_path, learnable_detection_root,
                                                 monkeypatch):
    """--checkpoint_every writes the checkpoint mid-run, --resume_from
    continues from it (the JAX package's test, in the port)."""
    ckpt = str(tmp_path / "mid.npz")
    cfg = _cfg(tmp_path, learnable_detection_root, ckpt)
    saved = []
    real = tck.save_params

    def spy(path, params):
        saved.append(path)
        real(path, params)

    monkeypatch.setattr(tck, "save_params", spy)
    loss1 = _quiet(ttrain.main, ["-c", str(cfg), "--train_steps", "10",
                                 "--checkpoint_every", "5", "--save_to", ckpt,
                                 "--learning_rate", "3e-3"] + CPU)
    monkeypatch.undo()
    assert saved == [ckpt] * 3  # steps 5 and 10, and the end
    p1 = tck.load_params(ckpt)
    assert "w_conv1" in p1 and np.isfinite(loss1)
    ckpt2 = str(tmp_path / "resumed.npz")
    loss2 = _quiet(ttrain.main, ["-c", str(cfg), "--train_steps", "40", "--resume_from",
                                 ckpt, "--save_to", ckpt2, "--learning_rate", "3e-3"] + CPU)
    assert np.isfinite(loss2) and loss2 < loss1
    assert not np.allclose(tck.load_params(ckpt2)["w_conv1"], p1["w_conv1"])


def _refusal(tmp_path, root, case):
    """argv for a refusal case, writing what it needs."""
    cfg = _cfg(tmp_path, root, "unused")
    base = ["-c", str(cfg), "--save_to", str(tmp_path / "x.npz")]
    if case == "train_steps 0":
        return base + ["--train_steps", "0"]
    if case == "keep_polarity":
        return base + ["--train_steps", "1", "--keep_polarity", "true"]
    if case == "unknown config key":
        cfg.write_text(cfg.read_text() + "learning_rat: 0.1\n")
        return base
    ckpt = tmp_path / "w.npz"
    weights = ttrain.init_params(layers_dict(LEARN_LAYERS))
    if case == "resume: missing tensor":
        weights.pop("b_conv2")
    else:  # resume: shape
        weights["w_conv1"] = np.zeros((5, 5, 1, 8), np.float32)
    tck.save_params(str(ckpt), weights)
    return base + ["--train_steps", "1", "--resume_from", str(ckpt)]


@pytest.mark.parametrize("case,error,match", [
    ("train_steps 0", SystemExit, "train_steps"),
    ("keep_polarity", SystemExit, "2-channel"),
    ("unknown config key", ValueError, "unknown config keys"),
    ("resume: missing tensor", ValueError, "missing 'b_conv2'"),
    ("resume: shape", ValueError, "shape"),
])
def test_train_cli_refusals_match_jax(tmp_path, learnable_detection_root, case, error, match):
    argv = _refusal(tmp_path, learnable_detection_root, case)
    for main, extra in ((jtrain.main, []), (ttrain.main, CPU)):
        with pytest.raises(error, match=match):
            _quiet(main, argv + extra)


def test_train_then_evaluate(tmp_path, learnable_detection_root):
    """The JAX package's pipeline test in the port, with its thresholds:
    400 steps from the seeded init, then evaluate at IoU 0.3 well above an
    untrained checkpoint's mAP."""
    ckpt = str(tmp_path / "trained.npz")
    cfg = _cfg(tmp_path, learnable_detection_root, ckpt)
    rng0 = np.random.RandomState(0)
    untrained = {}
    for name, dims in (("conv1", (3, 3, 1, 8)), ("conv2", (3, 3, 8, 16)),
                       ("conv3", (1, 1, 16, 12))):
        untrained[f"w_{name}"] = rng0.randn(*dims).astype(np.float32) * 0.1
        untrained[f"b_{name}"] = np.zeros(dims[-1], np.float32)
    base_ckpt = str(tmp_path / "untrained.npz")
    tck.save_params(base_ckpt, untrained)
    base = _quiet(teval.main, ["-c", str(cfg), "--batch_size", "1", "--restore_net",
                               base_ckpt, "--eval_iou", "0.3"] + CPU)
    loss = _quiet(ttrain.main, ["-c", str(cfg), "--train_steps", "400", "--learning_rate",
                                "3e-3", "--save_to", ckpt] + CPU)
    assert np.isfinite(loss) and loss < 0.5
    result = _quiet(teval.main, ["-c", str(cfg), "--batch_size", "1", "--eval_iou", "0.3"]
                    + CPU)
    assert result["mAP"] >= 0.25, result
    assert result["mAP"] >= base["mAP"] + 0.2, (result, base)


# ---- evaluate and run_networks on the tiny tree of tests/test_cli.py ------------


@pytest.fixture
def tiny_detection_root(tmp_path, rng):
    """tests/test_cli.py's tree, plus one test example whose events all lie
    outside the centre crop (zero micro-batches: an empty prediction)."""
    reader = NReader()
    root = tmp_path / "det"
    (root / "annotations").mkdir(parents=True)
    for split, k in (("train", 2), ("test", 2), ("validation", 1)):
        d = root / split
        d.mkdir()
        for i in range(k):
            n = 300
            x = rng.randint(0, 24, n).astype(np.int32)
            y = rng.randint(0, 20, n).astype(np.int32)
            ts = np.sort(rng.randint(0, 60000, n)).astype(np.int32)
            p = rng.randint(0, 2, n).astype(np.int32)
            name = f"{split}_ex{i}"
            reader.save_example(str(d / f"{name}.bin"), x, y, ts, p)
            np.save(str(root / "annotations" / f"{name}.npy"),
                    rng.rand(1, 6).astype(np.float32))
    # corners (0, 0) and (23, 19) only: the 16x20 crop of the 20x24 extent
    # starts at (1, 1) and ends before (17, 21)
    n = 40
    corner = np.arange(n) % 2
    reader.save_example(str(root / "test" / "test_ex2.bin"), (corner * 23).astype(np.int32),
                        (corner * 19).astype(np.int32), np.arange(n, dtype=np.int32) * 10,
                        corner.astype(np.int32))
    np.save(str(root / "annotations" / "test_ex2.npy"),
            np.array([[0.5, 0.5, 0.2, 0.2, 1, 0]], np.float32))
    np.savez(str(root / "params.npz"), num_classes=3,
             label_to_idx=np.array([("a", 0), ("b", 1), ("c", 2)], dtype=object))
    return root


def _write_cfg(tmp_path, root, network, ckpt):
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(
        f"input_data_dir: {root}\n"
        "file_format: n-data\n"
        f"network: {network}\n"
        f"restore_net: {ckpt}\n"
        "leak: 1.0e-04\n"
        "batch_size: 1\n"
        "batch_event_size: 100\n"
        "frame_h: 16\nframe_w: 20\nexample_h: 20\nexample_w: 24\n"
        "yolo_cnn_layers: conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,8 pool2=2,2 conv3=1,1,8,13\n"
        "yolo_cnn_padding: SAME\n"
        "yolo_num_cells_h: 4\nyolo_num_cells_w: 5\nyolo_num_bbox: 2\n"
    )
    return cfg


@pytest.fixture
def tiny_ckpt(tmp_path, rng):
    params = {}
    for name, (kh, kw, ci, co) in (
        ("conv1", (3, 3, 1, 4)), ("conv2", (3, 3, 4, 8)), ("conv3", (1, 1, 8, 13))
    ):
        params[f"w_{name}"] = rng.randn(kh, kw, ci, co).astype(np.float32) * 0.2
        params[f"b_{name}"] = rng.randn(co).astype(np.float32) * 0.1
    path = str(tmp_path / "weights.npz")
    tck.save_params(path, params)
    return path


def _json_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def trained_tree(tmp_path_factory):
    """The learnable tree and a checkpoint the port's train CLI fitted to
    it (150 steps), so that evaluate scores real detections."""
    tmp = tmp_path_factory.mktemp("trained")
    root = _write_learnable_tree(tmp / "det", np.random.RandomState(1234))
    ckpt = str(tmp / "trained.npz")
    _quiet(ttrain.main, ["-c", str(_cfg(tmp, root, "unused")), "--train_steps", "150",
                         "--learning_rate", "3e-3", "--save_to", ckpt] + CPU)
    return root, ckpt


@pytest.mark.parametrize("network,mode", [
    ("YoloEventJax", "dense"), ("YoloEventJax", "sparse_pallas"),
    ("YoloEventNumpy", "dense"), ("YoloFrameJax", "dense"), ("YoloFrameTf", "dense"),
    ("YoloFrameNumpy", "dense"),
])
@pytest.mark.parametrize("tree", ["cropped", "trained"])
def test_evaluate_matches_jax(tmp_path, tiny_detection_root, tiny_ckpt, trained_tree,
                              monkeypatch, capsys, network, mode, tree):
    """The JSON line equal to the JAX CLI's, on the tiny tree with a fully
    cropped example (random weights) and on the learnable tree with a
    trained checkpoint (a non-zero mAP); each example's grid and decoded
    scores within 1e-5."""
    import async_ev_cnn_torch.utils.evaluation as tev

    if tree == "cropped":
        cfg = _write_cfg(tmp_path, tiny_detection_root, network, tiny_ckpt)
        iou, examples, decoded = "0.5", 3, 2
    else:
        root, ckpt = trained_tree
        cfg = _cfg(tmp_path, root, ckpt)
        cfg.write_text(cfg.read_text().replace("YoloEventJax", network))
        iou, examples, decoded = "0.3", 8, 8
    seen = {"jax": [], "torch": []}

    def spy(real, into):
        def decode(grid, *args, **kw):
            out = real(grid, *args, **kw)
            into.append((np.asarray(grid), out))
            return out
        return decode

    monkeypatch.setattr(jeval, "decode_predictions", spy(jeval.decode_predictions, seen["jax"]))
    monkeypatch.setattr(tev, "decode_predictions", spy(tev.decode_predictions, seen["torch"]))
    argv = ["-c", str(cfg), "--mode", mode, "--eval_iou", iou]
    want_result = jeval.main(argv)
    want = _json_line(capsys)
    got_result = teval.main(argv + CPU)
    got = _json_line(capsys)
    assert got == want
    assert got["examples"] == examples and len(seen["torch"]) == len(seen["jax"]) == decoded
    if tree == "trained":
        assert got[f"mAP@{iou}"] > 0.1, got
    assert got_result["num_gt_per_class"] == want_result["num_gt_per_class"]
    for (g_grid, (g_boxes, g_scores, g_cls)), (w_grid, (w_boxes, w_scores, w_cls)) in zip(
            seen["torch"], seen["jax"]):
        np.testing.assert_allclose(g_grid, w_grid, rtol=0, atol=GRID_TOL)
        np.testing.assert_array_equal(g_cls, w_cls)
        np.testing.assert_allclose(g_scores, w_scores, rtol=0, atol=SCORE_TOL)
        np.testing.assert_allclose(g_boxes, w_boxes, rtol=0, atol=1e-3)


RUNS = [
    ("YoloEventJax", []), ("YoloFrameJax", []), ("YoloEventNumpy", []),
    ("YoloFrameNumpy", []), ("YoloEventTorch", []), ("YoloFrameTorch", []),
    ("YoloEventJax", ["--batch_event_usec", "5000"]),
    ("YoloEventJax", ["--runner", "scan"]),
    ("YoloEventJax", ["--runner", "scan", "--batch_event_usec", "5000"]),
    ("YoloEventJax", ["--runner", "scan", "--mode", "full"]),
    ("YoloEventJax", ["--runner", "scan", "--mode", "full", "--ts_window", "8"]),
    ("YoloEventJax", ["--mode", "full", "--stem_fusion", "true"]),
    ("YoloEventJax", ["--mode", "sparse_pallas"]),
    ("YoloEventJax", ["--mode", "sparse_rows"]),
    ("YoloEventJax", ["@mixed"]),
]


@pytest.mark.parametrize("network,extra", RUNS,
                         ids=[f"{n}{''.join(e)}" for n, e in RUNS])
def test_run_networks_matches_jax(tmp_path, tiny_detection_root, tiny_ckpt, capsys,
                                  network, extra):
    """Every runner and flag of tests/test_cli.py (and the port's own
    network names): the port's stats line has the JAX CLI's keys and
    counts, and positive rates."""
    cfg = _write_cfg(tmp_path, tiny_detection_root, network, tiny_ckpt)
    if extra == ["@mixed"]:  # per-layer @mode DSL: window early, full late
        cfg.write_text(cfg.read_text().replace("conv1=3,3,1,4", "conv1=3,3,1,4@window")
                       .replace("conv2=3,3,4,8", "conv2=3,3,4,8@full"))
        extra = []
    argv = ["-c", str(cfg)] + extra
    got = trun.main(argv + CPU)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    if "Torch" in network:  # the JAX package's name of the same network
        cfg.write_text(cfg.read_text().replace("Torch", "Jax"))
    want = jrun.main(argv)
    assert sorted(got) == sorted(want)
    for key in ("steps", "examples"):
        assert got.get(key) == want.get(key)
    assert got.get("steps", got.get("examples")) >= 2
    assert got["events_per_sec"] > 0


def test_run_networks_polarity_channels(tmp_path, tiny_detection_root, rng):
    """A 2-channel (ON/OFF) surface network through the step runner."""
    params = {}
    for name, (kh, kw, ci, co) in (
        ("conv1", (3, 3, 2, 4)), ("conv2", (3, 3, 4, 8)), ("conv3", (1, 1, 8, 13))
    ):
        params[f"w_{name}"] = rng.randn(kh, kw, ci, co).astype(np.float32) * 0.2
        params[f"b_{name}"] = rng.randn(co).astype(np.float32) * 0.1
    ckpt = str(tmp_path / "w2.npz")
    tck.save_params(ckpt, params)
    cfg = _write_cfg(tmp_path, tiny_detection_root, "YoloEventJax", ckpt)
    argv = ["-c", str(cfg), "--keep_polarity", "true", "--yolo_cnn_layers",
            "conv1=3,3,2,4 pool1=2,2 conv2=3,3,4,8 pool2=2,2 conv3=1,1,8,13"]
    got = _quiet(trun.main, argv + CPU)
    want = _quiet(jrun.main, argv)
    assert got["steps"] == want["steps"] >= 2


def test_run_networks_refusals(tmp_path, tiny_detection_root, tiny_ckpt):
    """The JAX CLI's refusals, those of --num_streams > 1 among them, and
    --num_ranks without --num_streams > 1."""
    cfg = _write_cfg(tmp_path, tiny_detection_root, "YoloEventJax", tiny_ckpt)
    for argv in (["--runner", "warp"], ["--runner", "scan", "--batch_size", "2"],
                 ["--runner", "scan", "--network", "YoloFrameJax"],
                 ["--network", "YoloEventTf"],
                 ["--num_streams", "2", "--network", "YoloFrameJax"],
                 ["--num_streams", "2", "--ts_window", "8"]):
        for main, extra in ((jrun.main, []), (trun.main, CPU)):
            with pytest.raises(SystemExit):
                _quiet(main, ["-c", str(cfg)] + argv + extra)
    with pytest.raises(SystemExit, match="--num_ranks takes --num_streams > 1"):
        trun.main(["-c", str(cfg), "--num_ranks", "2"] + CPU)
    with pytest.raises(SystemExit, match="no network layers"):
        trun.main(["--input_data_dir", str(tiny_detection_root)] + CPU)


def test_run_networks_default_tier_warning_and_profile(tmp_path, tiny_detection_root,
                                                       tiny_ckpt, capsys, monkeypatch):
    """The 'default'-tier warning for incremental modes (on standard
    error, not for 'full'), and --profile's torch.profiler trace."""
    from async_ev_cnn_torch.ops.conv import set_matmul_precision

    cfg = _write_cfg(tmp_path, tiny_detection_root, "YoloEventJax", tiny_ckpt)
    monkeypatch.chdir(tmp_path)
    try:
        trun.main(["-c", str(cfg), "--matmul_precision", "default"] + CPU)
        assert "WARNING: --matmul_precision default" in capsys.readouterr().err
        trun.main(["-c", str(cfg), "--matmul_precision", "default", "--mode", "full",
                   "--runner", "scan", "--profile", "true"] + CPU)
        captured = capsys.readouterr()
        assert "WARNING" not in captured.err
        assert "profiler trace written" in captured.out
    finally:
        set_matmul_precision("highest")
    trace = json.loads((tmp_path / "torch_trace" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_cli_entry_points_raise_without_a_device(monkeypatch, tmp_path, tiny_detection_root,
                                                 tiny_ckpt):
    """With no --device and no CUDA device, the three CLIs and the trainer's
    callers raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _write_cfg(tmp_path, tiny_detection_root, "YoloEventJax", tiny_ckpt)
    for main, extra in ((trun.main, []), (teval.main, []),
                        (ttrain.main, ["--save_to", str(tmp_path / "x.npz")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _quiet(main, ["-c", str(cfg)] + extra)
