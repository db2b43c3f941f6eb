"""The port's mesh paths above the engines held against the JAX package:
StreamingPipeline(mesh=...) (utils/serving.py), the multi-stream runner
behind ``run_networks --num_streams`` (utils/runner.MultiStreamRunner,
scripts/run_networks.py) and the dry run (parallel/dryrun.py).

The mesh pipeline runs as 4 gloo ranks spawned once for the module (the
rank side is tests/torch_parallel_ranks.py); the JAX mesh pipeline runs
here on the first 4 of the conftest's virtual CPU devices, on the same
2 x 2 mesh.  Inputs are tests/test_serving.py's seeded draws.

Tolerances:
* the gathered results of the mesh pipeline: outputs within 1e-5 of the
  JAX mesh pipeline's and of the port's unsharded pipeline (float32 convs
  split over channels and batched otherwise), events and counts exact;
  the end surfaces within 1e-6 of the JAX pipeline's (its CPU integrate
  engine is the max-plus scan, ~1 ulp from the exact chain) and bit for
  bit against the port's unsharded pipeline;
* run_networks --num_streams 2: the JAX CLI's example count;
* the dry run: every leg within 1e-5 of the unsharded path.
"""

import json

import numpy as np
import pytest
import torch

import jax

import torch_parallel_ranks as ranks
from async_ev_cnn_torch.data.file_reader import NReader
from async_ev_cnn_torch.parallel.dryrun import LEGS, dryrun_multichip
from async_ev_cnn_torch.parallel.launch import launch
from async_ev_cnn_torch.scripts import run_networks as trun
from async_ev_cnn_torch.utils import checkpoint as tck
from async_ev_cnn_torch.utils.serving import StreamingPipeline as TPipeline
from async_ev_cnn_torch.utils.weights import params_from_jax
from async_ev_cnn_tpu.layers.network import EventNetwork as JNet
from async_ev_cnn_tpu.parallel import make_mesh as jmake_mesh
from async_ev_cnn_tpu.scripts import run_networks as jrun
from async_ev_cnn_tpu.utils.config import layers_dict
from async_ev_cnn_tpu.utils.serving import StreamingPipeline as JPipeline

torch.set_num_threads(2)

RANKS = 4
CAP = 32
DSL = "conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,8 pool2=2,2 conv3=1,1,8,12"
TOL = 1e-5
SURF_TOL = 1e-6
CPU = ["--device", "cpu"]


def _stream(rng, n):
    """tests/test_serving.py's _stream."""
    y = rng.randint(0, 16, n).astype(np.int32)
    x = rng.randint(0, 16, n).astype(np.int32)
    ts = np.cumsum(rng.randint(1, 20, n)).astype(np.int32)
    return np.stack([y, x, ts], axis=-1)


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(1234)
    params = {}
    for name, size in layers_dict(DSL).items():
        if "conv" in name:
            params[f"w_{name}"] = rng.randn(*size).astype(np.float32) * 0.1
            params[f"b_{name}"] = rng.randn(size[3]).astype(np.float32) * 0.1
    items = [_stream(rng, CAP) for _ in range(8)]  # 2 dispatches x 4 streams
    # one dispatch whose last two streams supply 3 chunks, the first two 1
    uneven = [_stream(rng, n) for n in (CAP, CAP, 3 * CAP, 3 * CAP)]
    return {"dsl": DSL, "cap": CAP, "params": params, "items": items, "uneven": uneven}


@pytest.fixture(scope="module")
def served(case):
    got = launch(ranks.serving_cases, RANKS, args=(case,), timeout=240)
    assert [r["rank"] for r in got] == list(range(RANKS))
    return got


def test_pipeline_mesh_sharded_matches_jax_and_unsharded(case, served):
    """StreamingPipeline(streams=4, mesh=2x2): every rank serves its 2
    streams a dispatch; the gathered results match the JAX mesh pipeline
    and the port's unsharded pipeline on the same source."""
    net = JNet(layers_dict(DSL), 16, 16, leak=1e-4, alpha=0.1, padding="SAME",
               conv_mode="full")
    jpipe = JPipeline(net, case["params"], capacity=CAP, streams=4,
                      mesh=jmake_mesh(n_data=2, n_model=2, devices=jax.devices()[:RANKS]))
    want = list(jpipe.serve(list(case["items"])))
    tnet = ranks.net_of(DSL, 16, 16, 1e-4, "full")
    tpipe = TPipeline(tnet, params_from_jax(case["params"], "cpu"), capacity=CAP, streams=4,
                      device="cpu")
    plain = list(tpipe.serve(list(case["items"])))
    assert len(want) == len(plain) == 2
    for r in served:
        assert [n for n, _ in r["own"]] == [2 * CAP, 2 * CAP]  # its 2 streams
        assert all(shape[0] == 2 for _, shape in r["own"])
        assert len(r["outputs"]) == 2
        for k in range(2):
            np.testing.assert_allclose(r["outputs"][k], np.asarray(want[k].outputs),
                                       rtol=0, atol=TOL)
            np.testing.assert_allclose(r["outputs"][k], plain[k].outputs.numpy(),
                                       rtol=0, atol=TOL)
            assert r["n_events"][k] == want[k].n_events == plain[k].n_events
            np.testing.assert_array_equal(r["counts"][k], plain[k].counts)
        np.testing.assert_allclose(r["surface"], np.asarray(jpipe.state[0].surface),
                                   rtol=0, atol=SURF_TOL)
        np.testing.assert_array_equal(r["surface"], tpipe.state[0].surface.numpy())
        np.testing.assert_array_equal(r["prev_ts"], np.asarray(jpipe.state[0].prev_ts))


def test_pipeline_mesh_requires_divisible_streams(served):
    """The JAX engine's ValueError: streams >= 2 and divisible by the data
    axis."""
    for r in served:
        assert "divisible by the mesh's data axis (= 2)" in r["err_div"]
        assert "streams (= 1)" in r["err_one"]


def test_pipeline_mesh_unequal_chunk_counts_raise_on_every_rank(case, served):
    """A dispatch whose two data ranks get items of 1 and of 3 chunks (no
    t_chunks): every rank raises the unsharded pipeline's ValueError before
    any collective, where each rank's own streams agree (and a rank-local
    check would let both go on to gather outputs of another T)."""
    tnet = ranks.net_of(DSL, 16, 16, 1e-4, "full")
    tpipe = TPipeline(tnet, params_from_jax(case["params"], "cpu"), capacity=CAP, streams=4,
                      device="cpu")
    with pytest.raises(ValueError, match=r"got chunk counts \[1, 3\]"):
        list(tpipe.serve(case["uneven"]))
    for r in served:
        assert "equally many chunks per dispatch (got chunk counts [1, 3])" in r["err_t"]


def _tree(tmp_path):
    """tests/test_cli.py's tiny detection tree and checkpoint."""
    rng = np.random.RandomState(1234)
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
            reader.save_example(str(d / f"{split}_ex{i}.bin"), x, y, ts, p)
            np.save(str(root / "annotations" / f"{split}_ex{i}.npy"),
                    rng.rand(1, 6).astype(np.float32))
    np.savez(str(root / "params.npz"), num_classes=2,
             label_to_idx=np.array([("a", 0), ("b", 1)], dtype=object))
    params = {}
    for name, (kh, kw, ci, co) in (("conv1", (3, 3, 1, 4)), ("conv2", (3, 3, 4, 8)),
                                   ("conv3", (1, 1, 8, 13))):
        params[f"w_{name}"] = rng.randn(kh, kw, ci, co).astype(np.float32) * 0.2
        params[f"b_{name}"] = rng.randn(co).astype(np.float32) * 0.1
    ckpt = str(tmp_path / "weights.npz")
    tck.save_params(ckpt, params)
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(
        f"input_data_dir: {root}\nfile_format: n-data\nnetwork: YoloEventJax\n"
        f"restore_net: {ckpt}\nleak: 1.0e-04\nbatch_size: 1\nbatch_event_size: 100\n"
        "frame_h: 16\nframe_w: 20\nexample_h: 20\nexample_w: 24\n"
        "yolo_cnn_layers: conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,8 pool2=2,2 conv3=1,1,8,13\n"
        "yolo_cnn_padding: SAME\nyolo_num_cells_h: 4\nyolo_num_cells_w: 5\nyolo_num_bbox: 2\n")
    return cfg


@pytest.mark.parametrize("extra, ranks_argv", [([], []), (["--mode", "full"], []),
                                               (["--mode", "full"], ["--num_ranks", "2"])])
def test_run_networks_multi_stream(tmp_path, capsys, extra, ranks_argv):
    """--num_streams 2 in one process (a world of 1, both streams on one
    device's stream axis: 'dense' through scan, 'full' through
    scan_parallel) and through 2 ranks started by --num_ranks: the JAX
    CLI's example count (tests/test_cli.py), and the stats line printed
    once."""
    cfg = _tree(tmp_path)
    argv = ["-c", str(cfg), "--num_streams", "2"] + extra
    want = jrun.main(argv)
    capsys.readouterr()
    got = trun.main(argv + ranks_argv + CPU)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == got
    assert sum(line.startswith("{") for line in lines) == 1
    assert set(got) == set(want)
    assert got["examples"] == want["examples"] == 2 and got["events_per_sec"] > 0
    assert not torch.distributed.is_initialized()


def test_dryrun_multichip_cpu(capsys):
    """dryrun_multichip(4, device='cpu'): 4 gloo ranks, every leg within
    1e-5 of the unsharded path."""
    out = dryrun_multichip(4, device="cpu")
    assert set(out["errors"]) == set(LEGS)
    assert all(err <= 1e-5 for err in out["errors"].values())
    assert "4 gloo ranks on cpu" in capsys.readouterr().out
