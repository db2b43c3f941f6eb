"""The port's multi-device layer (async_ev_cnn_torch/parallel/) held
against the JAX package's (async_ev_cnn_tpu/parallel/) and against the
port's unsharded path.

The port runs as 4 gloo ranks, spawned once for the module
(tests/torch_parallel_ranks.py holds what the ranks run: spawned ranks
must not import jax, which this module does); the JAX references run here
on the conftest's virtual CPU devices, on the same mesh shapes (the first
4 devices).  Inputs are tests/test_parallel.py's seeded numpy draws.

Tolerances:
* MultiStreamEngine ``scan`` ('dense') on (4, 1) and (2, 2) meshes and
  ``scan_parallel`` on (2, 2): within 1e-5 of the JAX engine and of
  per-stream ``EventNetwork.scan`` (float32 convs split over channels);
  the mesh of size 1: both streams equal, bit for bit;
* TimeShardEngine on 4 ranks and dp x sp on 2 x 2: the final surfaces bit
  for bit against the JAX engine's (the same max-plus grouping), the same
  on every rank; outputs within 1e-5; 20 chained dispatches within 1e-4 of
  the sequential scan;
* the time shard's collectives: the same at T = 32 and T = 64, and exactly
  the ts gather and the two C*H*W gathers;
* the data-parallel Trainer: loss and parameters within 1e-5 of the JAX
  mesh trainer and of the port's unsharded one, the same on every rank.
"""

import time
from collections import OrderedDict

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

import torch_parallel_ranks as ranks
from async_ev_cnn_torch.models.train import Trainer as TTrainer
from async_ev_cnn_torch.models.train import YoloTargets as TTargets
from async_ev_cnn_torch.parallel import (
    MultiStreamEngine,
    make_mesh,
    make_time_mesh,
    world,
)
from async_ev_cnn_torch.parallel.launch import launch
from async_ev_cnn_torch.utils.equivalence import make_stream
from async_ev_cnn_torch.utils.runner import pack_chunks
from async_ev_cnn_torch.utils.weights import params_from_jax
from async_ev_cnn_tpu.layers.network import EventNetwork as JNet
from async_ev_cnn_tpu.layers.types import EventChunk as JChunk
from async_ev_cnn_tpu.models.train import Trainer as JTrainer
from async_ev_cnn_tpu.models.train import YoloTargets as JTargets
from async_ev_cnn_tpu.parallel import MultiStreamEngine as JEngine
from async_ev_cnn_tpu.parallel import TimeShardEngine as JTimeShard
from async_ev_cnn_tpu.parallel import make_mesh as jmake_mesh
from async_ev_cnn_tpu.parallel import make_time_mesh as jmake_time_mesh
from async_ev_cnn_tpu.utils.config import layers_dict

torch.set_num_threads(2)

RANKS = 4
TOL = 1e-5
SEQ_TOL = 1e-4
ENGINE_LAYERS = [("conv1", [3, 3, 1, 8]), ("pool1", [2, 2]), ("conv2", [3, 3, 8, 16]),
                 ("pool2", [2, 2])]
FULL_LAYERS = [("conv1", [3, 3, 1, 8]), ("pool1", [2, 2]), ("conv2", [1, 1, 8, 12])]
TRAIN_LAYERS = "conv1=3,3,1,8 pool1=2,2 conv2=3,3,8,16 pool2=2,2 conv3=1,1,16,13"


def _engine_params(rng):
    """tests/test_parallel.py's build_net_params draws (HWIO)."""
    return {
        "w_conv1": rng.randn(3, 3, 1, 8).astype(np.float32) * 0.3,
        "b_conv1": rng.randn(8).astype(np.float32) * 0.1,
        "w_conv2": rng.randn(3, 3, 8, 16).astype(np.float32) * 0.3,
        "b_conv2": rng.randn(16).astype(np.float32) * 0.1,
    }


def _params(layers, rng, w_scale, b_scale):
    out = {}
    for name, size in OrderedDict(layers).items():
        if "conv" in name:
            out[f"w_{name}"] = rng.randn(*size).astype(np.float32) * w_scale
            out[f"b_{name}"] = rng.randn(size[3]).astype(np.float32) * b_scale
    return out


def _planes(chunk):
    return tuple(f.numpy() for f in chunk)


def _stream(rng, steps, **kw):
    return _planes(make_stream(rng, steps, 6, 16, 16, device="cpu", **kw))


def _shift(planes, base):
    y, x, ts, p, valid = planes
    return y, x, ts + base, p, valid


def _stack(streams, axis):
    return tuple(np.stack(f, axis=axis) for f in zip(*streams))


def _jchunk(planes):
    return JChunk(*(jnp.asarray(a) for a in planes))


def _jnet(layers, leak, mode):
    defs = layers_dict(layers) if isinstance(layers, str) else OrderedDict(layers)
    return JNet(defs, 16, 16, leak=leak, alpha=0.1, padding="SAME", conv_mode=mode)


def _jparams(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _train_batch(rng, n):
    """tests/test_train.py's toy_batch (numpy)."""
    frames = rng.rand(n, 16, 16).astype(np.float32)
    boxes = np.zeros((n, 4, 4, 4), np.float32)
    obj = np.zeros((n, 4, 4), np.float32)
    cls = np.zeros((n, 4, 4), np.int32)
    for i in range(n):
        cy, cx = int(frames[i, :4, :4].sum() * 7) % 4, i % 4
        obj[i, cy, cx] = 1
        boxes[i, cy, cx] = [0.5, 0.5, 0.25, 0.25]
        cls[i, cy, cx] = i % 3
        frames[i, cy * 4:cy * 4 + 4, cx * 4:cx * 4 + 4] += 1.0
    return frames, (boxes, obj, cls)


@pytest.fixture(scope="module")
def cases():
    """The seeded inputs of every case (the same go through JAX here)."""
    out = {}
    for name, mesh, mode in (("dp", (4, 1), "dense"), ("dpmp", (2, 2), "dense"),
                             ("scanpar", (2, 2), "full")):
        rng = np.random.RandomState(1234)
        params = _engine_params(rng)
        streams = [_stream(rng, 8) for _ in range(4)]
        out[name] = {"layers": ENGINE_LAYERS, "mode": mode, "mesh": mesh, "params": params,
                     "streams": streams, "chunks": _stack(streams, 1)}
    rng = np.random.RandomState(1234)
    params = _params(FULL_LAYERS, rng, 0.2, 0.2)
    s1 = _stream(rng, 16)
    s2 = _shift(_stream(rng, 16), int(s1[2].max()))
    out["ts"] = {"layers": FULL_LAYERS, "params": params, "streams": [s1, s2]}
    rng = np.random.RandomState(1234)
    pol_layers = [("conv1", [3, 3, 2, 8]), ("conv2", [1, 1, 8, 4])]
    out["pol"] = {"layers": pol_layers, "params": _params(pol_layers, rng, 0.2, 0.2),
                  "stream": _stream(rng, 8, random_polarity=True)}
    rng = np.random.RandomState(1234)
    params = _params(FULL_LAYERS, rng, 0.2, 0.2)
    streams = [_stream(rng, 8) for _ in range(4)]
    out["dpsp"] = {"layers": FULL_LAYERS, "params": params, "streams": streams,
                   "chunks": _stack(streams, 0)}
    rng = np.random.RandomState(1234)
    params = _params(FULL_LAYERS, rng, 0.2, 0.2)
    streams, base = [], 0
    for _ in range(20):
        s = _shift(_stream(rng, 16), base)
        base = int(s[2].max())
        streams.append(s)
    out["drift"] = {"layers": FULL_LAYERS, "params": params, "streams": streams}
    rng = np.random.RandomState(1234)
    dsl = "conv1=3,3,1,4 pool1=2,2 conv2=1,1,4,6"
    out["traffic"] = {"layers": dsl, "params": _params(layers_dict(dsl), rng, 1.0, 1.0)}
    for t in (32, 64):
        ev = np.stack([rng.randint(0, 16, t * 8), rng.randint(0, 16, t * 8),
                       np.sort(rng.randint(1, 10000, t * 8))], axis=-1).astype(np.int32)
        out["traffic"][f"t{t}"] = _planes(pack_chunks(ev, 8, device="cpu"))
    rng = np.random.RandomState(1234)
    frames, targets = _train_batch(rng, 16)
    out["trainer"] = {"layers": TRAIN_LAYERS,
                      "params": _params(layers_dict(TRAIN_LAYERS), rng, 0.2, 0.05),
                      "frames": frames, "targets": targets}
    return out


@pytest.fixture(scope="module")
def results(cases):
    """Every case on one spawned group of 4 gloo ranks; per-rank results."""
    got = launch(ranks.engine_cases, RANKS, args=(cases,), timeout=240)
    assert [r["rank"] for r in got] == list(range(RANKS))
    return got


def _port_scan(c, s):
    net = ranks.net_of(c["layers"], 16, 16, 0.01, c["mode"])
    params = params_from_jax(c["params"], "cpu")
    _, outs = net.scan(params, net.init_state(params, "cpu"), ranks.chunks_of(c["streams"][s]))
    return outs.numpy()


def _jax_engine(c, mesh):
    net = _jnet(c["layers"], 0.01, c["mode"])
    eng = JEngine(net, jmake_mesh(*mesh, devices=jax.devices()[:RANKS]))
    p = eng.place_params(_jparams(c["params"]))
    st = eng.init_states(p, 4)
    fn = eng.scan_parallel if c["mode"] == "full" else eng.scan
    return np.asarray(fn(p, st, eng.place_chunks(_jchunk(c["chunks"]), leading_time=True))[1])


@pytest.mark.parametrize("name", ["dp", "dpmp", "scanpar"])
def test_multi_stream_engine_matches_jax_and_per_stream_scan(cases, results, name):
    """data-parallel, data x model 'dense' scan, and scan_parallel over the
    mesh: the gathered outputs on every rank within 1e-5 of the JAX engine
    on the same mesh shape and of each stream's own scan."""
    c = cases[name]
    want = _jax_engine(c, c["mesh"])
    for r in results:
        got = r[name]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        for s in range(4):
            np.testing.assert_allclose(got[:, s], _port_scan(c, s), rtol=0, atol=TOL)


def test_mesh_size_one_fallback(cases):
    """The one-device deployment: a world of 1 (gloo on a HashStore, here in
    this process), two identical streams on a 1 x 1 mesh give identical
    outputs, within 1e-5 of the JAX engine's mesh of size 1."""
    c = cases["dp"]
    stream = tuple(a[:3] for a in c["streams"][0])
    chunks = tuple(np.repeat(a[:, None], 2, axis=1) for a in stream)
    net = ranks.net_of(c["layers"], 16, 16, 0.01, "dense")
    params = params_from_jax(c["params"], "cpu")
    with world("cpu"):
        eng = MultiStreamEngine(net, make_mesh(1, 1, device="cpu"))
        _, outs = eng.scan(eng.place_params(params), eng.init_states(params, 2),
                           eng.place_chunks(ranks.chunks_of(chunks), leading_time=True))
        outs = eng.gather(outs).numpy()
    assert not dist.is_initialized()
    assert outs.shape[1] == 2
    np.testing.assert_array_equal(outs[:, 0], outs[:, 1])
    jnet = _jnet(c["layers"], 0.01, "dense")
    jeng = JEngine(jnet, jmake_mesh(1, 1, devices=jax.devices()[:1]))
    p = jeng.place_params(_jparams(c["params"]))
    _, want = jeng.scan(p, jeng.init_states(p, 2),
                        jeng.place_chunks(_jchunk(chunks), leading_time=True))
    np.testing.assert_allclose(outs, np.asarray(want), rtol=0, atol=TOL)


def test_mesh_errors():
    """make_mesh and make_time_mesh raise the JAX package's ValueErrors, and
    a mesh that does not cover the world is refused."""
    with world("cpu"):
        for call, match in ((lambda: make_mesh(n_model=2, device="cpu"), "does not fit"),
                            (lambda: make_mesh(n_data=0, device="cpu"), "zero-size"),
                            (lambda: make_mesh(n_data=2, device="cpu"), "does not cover"),
                            (lambda: make_time_mesh(2, device="cpu"), "only 1 available"),
                            (lambda: make_time_mesh(1, n_streams=2, device="cpu"),
                             "not divisible"),
                            (lambda: make_mesh(device="cpu", backend="nccl"), "runs 'gloo'")):
            with pytest.raises(ValueError, match=match):
                call()
        mesh = make_time_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("time",)
    with pytest.raises(ValueError, match="NCCL runs on 'cuda' only"):
        make_mesh(device="cpu", backend="nccl")
    assert not dist.is_initialized()


def test_mesh_entry_points_need_a_device(monkeypatch):
    """Without a device given and no CUDA device present, the meshes and
    the dry run raise before starting anything; no group is left."""
    from async_ev_cnn_torch.parallel.dryrun import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (make_mesh, make_time_mesh, lambda: dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not dist.is_initialized()


def _jax_time_shard(c, mesh, states, chunks, stream_axis=None):
    net = _jnet(c["layers"], 0.05, "full")
    eng = JTimeShard(net, mesh, stream_axis=stream_axis)
    return eng.scan_parallel(_jparams(c["params"]), states, chunks)


def test_time_shard_matches_jax_and_scan_parallel(cases, results):
    """One stream's time axis over 4 ranks, two chained dispatches: the
    state bit-equal to the JAX TimeShardEngine's and the same on every
    rank, outputs within 1e-5 of it; both dispatches within 1e-4 of the
    sequential scan over their concatenation."""
    c = cases["ts"]
    jnet = _jnet(c["layers"], 0.05, "full")
    mesh = jmake_time_mesh(RANKS, devices=jax.devices()[:RANKS])
    st = jnet.init_state(_jparams(c["params"]))
    for k, planes in enumerate(c["streams"]):
        st, want = _jax_time_shard(c, mesh, st, _jchunk(planes))
        for r in results:
            np.testing.assert_array_equal(_bits(r[f"ts_surface{k}"]), _bits(st[0].surface))
            assert r[f"ts_prev_ts{k}"] == int(st[0].prev_ts)
            np.testing.assert_allclose(r[f"ts_outs{k}"], np.asarray(want), rtol=0, atol=TOL)
    net = ranks.net_of(c["layers"], 16, 16, 0.05, "full")
    params = params_from_jax(c["params"], "cpu")
    both = ranks.chunks_of(tuple(np.concatenate(f) for f in zip(*c["streams"])))
    _, seq = net.scan(params, net.init_state(params, "cpu"), both)
    got = np.concatenate([results[0]["ts_outs0"], results[0]["ts_outs1"]])
    np.testing.assert_allclose(got, seq.numpy(), rtol=0, atol=SEQ_TOL)


def test_time_shard_polarity_and_errors(cases, results):
    """The 2-channel polarity surface within 1e-5 (outputs) and bit for bit
    (state) of the JAX engine; the refusals raise before any collective."""
    c = cases["pol"]
    jnet = _jnet(c["layers"], 0.05, "full")
    st, want = _jax_time_shard(c, jmake_time_mesh(RANKS, devices=jax.devices()[:RANKS]),
                               jnet.init_state(_jparams(c["params"])), _jchunk(c["stream"]))
    for r in results:
        np.testing.assert_allclose(r["pol_outs"], np.asarray(want), rtol=0, atol=TOL)
        np.testing.assert_array_equal(_bits(r["pol_surface"]), _bits(st[0].surface))
        assert "not divisible by time-axis size 4" in r["err_t"]
        assert "conv_mode='full'" in r["err_mode"]
        assert "no axis 'data'" in r["err_axis"]
        assert "S=3 not divisible by stream-axis size 2" in r["err_s"]


def test_time_shard_streams_2d_mesh(cases, results):
    """dp x sp on a (data, time) mesh of 2 x 2: 4 streams, outputs within
    1e-5 and the end state bit for bit against the JAX engine's."""
    c = cases["dpsp"]
    jnet = _jnet(c["layers"], 0.05, "full")
    base = jnet.init_state(_jparams(c["params"]))
    states = jax.tree.map(lambda a: jnp.broadcast_to(a, (4, *a.shape)), base)
    mesh = jmake_time_mesh(RANKS, devices=jax.devices()[:RANKS], n_streams=2)
    st, want = _jax_time_shard(c, mesh, states, _jchunk(c["chunks"]), stream_axis="data")
    for r in results:
        assert r["dpsp_names"] == ["data", "time"]
        assert r["dpsp_outs"].shape[:2] == (4, 8)
        np.testing.assert_allclose(r["dpsp_outs"], np.asarray(want), rtol=0, atol=TOL)
        np.testing.assert_array_equal(_bits(r["dpsp_surface"]), _bits(st[0].surface))
        np.testing.assert_array_equal(r["dpsp_prev_ts"], np.asarray(st[0].prev_ts))


def test_time_shard_long_horizon_drift(cases, results):
    """20 chained time-sharded dispatches (320 chunks) track the sequential
    scan within 1e-4, dispatch by dispatch and in the end state."""
    c = cases["drift"]
    net = ranks.net_of(c["layers"], 16, 16, 0.02, "full")
    params = params_from_jax(c["params"], "cpu")
    st = net.init_state(params, "cpu")
    for k, planes in enumerate(c["streams"]):
        st, seq = net.scan(params, st, ranks.chunks_of(planes))
        np.testing.assert_allclose(results[0]["drift_outs"][k], seq.numpy(), rtol=0,
                                   atol=SEQ_TOL)
    np.testing.assert_allclose(results[0]["drift_surface"], st[0].surface.numpy(), rtol=0,
                               atol=SEQ_TOL)
    for r in results[1:]:
        np.testing.assert_array_equal(_bits(r["drift_surface"]),
                                      _bits(results[0]["drift_surface"]))


def test_time_shard_traffic_independent_of_T(results):
    """The collectives of one time-sharded dispatch, counted by the port's
    collective helper: the same at T = 32 and T = 64, and exactly the
    all_gather of one int32 maximum and the two all_gathers of the C*H*W
    totals (one stream, C = 1, 16x16)."""
    for r in results:
        assert r["traffic_t32"] == r["traffic_t64"]
        assert r["traffic_t32"] == [(("all_gather", (1,), "torch.int32"), 1),
                                    (("all_gather", (1, 1, 16, 16), "torch.float32"), 2)]


def test_trainer_data_parallel_matches_jax_and_unsharded(cases, results):
    """Trainer(mesh) at n_data = 4, one step of batch 16: loss and every
    parameter within 1e-5 of the JAX mesh trainer and of the port's
    unsharded trainer, the parameters and Adam's moments the same on every
    rank; a batch the data axis does not divide raises."""
    c = cases["trainer"]
    frames, targets = c["frames"], c["targets"]
    jnet = _jnet(TRAIN_LAYERS, 1e-4, "dense")
    jt = JTrainer(jnet, 3, 2, (4, 4), mesh=jmake_mesh(4, 1, devices=jax.devices()[:RANKS]))
    jp = _jparams(c["params"])
    jp, _, jloss = jt.step(jp, jt.init(jp), jnp.asarray(frames),
                           JTargets(*(jnp.asarray(a) for a in targets)))
    net = ranks.net_of(TRAIN_LAYERS, 16, 16, 1e-4, "dense")
    tt = TTrainer(net, 3, 2, (4, 4))
    tp = params_from_jax(c["params"], "cpu")
    tp, _, tloss = tt.step(tp, tt.init(tp), torch.from_numpy(frames),
                           TTargets(*(torch.from_numpy(a) for a in targets)))
    want = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    r0 = results[0]
    assert abs(r0["train_loss"] - float(jloss)) <= TOL * max(1.0, abs(float(jloss)))
    assert abs(r0["train_loss"] - float(tloss)) <= TOL * max(1.0, abs(float(tloss)))
    for k in tp:
        np.testing.assert_allclose(r0["train_params"][k], want[k].numpy(), rtol=0, atol=TOL)
        np.testing.assert_allclose(r0["train_params"][k], tp[k].detach().numpy(), rtol=0,
                                   atol=TOL)
    for r in results[1:]:
        assert r["train_loss"] == r0["train_loss"]
        for k in tp:
            np.testing.assert_array_equal(r["train_params"][k], r0["train_params"][k])
            np.testing.assert_array_equal(r["train_adam"][k], r0["train_adam"][k])
    for r in results:
        assert "batch of 6 not divisible by the mesh's data axis (4)" in r["err_batch"]


def test_stuck_rank_fails_within_the_group_timeout():
    """A rank waiting in a collective of a mesh axis that make_mesh built
    (the port's group timeout set to 2 s in the ranks), which another rank
    never joins, fails at that timeout, and the launcher ends every rank
    and raises."""
    t0 = time.perf_counter()
    with pytest.raises(Exception, match="(?i)timed out|timeout"):
        launch(ranks.stuck_rank, 2, args=(2.0,), timeout=60)
    assert time.perf_counter() - t0 < 45
