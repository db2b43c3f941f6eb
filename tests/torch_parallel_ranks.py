"""The rank side of tests/test_torch_parallel.py and
tests/test_torch_parallel_serving.py.

The ranks are spawned processes (``async_ev_cnn_torch.parallel.launch``)
that import their target by module path, and the test modules import jax
at the top, so every function a rank runs lives here: this module imports
numpy, torch and the port only.  Each case takes the seeded numpy inputs
the test module made (the same go through the JAX package there) and
returns numpy results; the test module holds them against the JAX
package and the port's unsharded path.
"""

from collections import OrderedDict

import numpy as np
import torch
import torch.distributed as dist

from async_ev_cnn_torch.layers.network import EventNetwork
from async_ev_cnn_torch.layers.types import EventChunk
from async_ev_cnn_torch.models.train import Trainer, YoloTargets
from async_ev_cnn_torch.parallel import (
    MultiStreamEngine,
    TimeShardEngine,
    make_mesh,
    make_time_mesh,
)
from async_ev_cnn_torch.utils.config import layers_dict
from async_ev_cnn_torch.utils.serving import StreamingPipeline
from async_ev_cnn_torch.utils.weights import params_from_jax

CPU = "cpu"


def net_of(layers, h, w, leak, mode, **kw):
    """The port's network for a layer dict or a DSL string."""
    defs = layers_dict(layers) if isinstance(layers, str) else OrderedDict(layers)
    return EventNetwork(defs, h, w, leak=leak, alpha=0.1, padding="SAME", conv_mode=mode,
                        **kw)


def chunks_of(planes) -> EventChunk:
    """Numpy ``(y, x, ts, p, valid)`` planes as a CPU chunk."""
    return EventChunk(*(torch.from_numpy(np.ascontiguousarray(a)) for a in planes))


def _np(x):
    return x.detach().cpu().numpy()


def _raises(fn) -> str:
    """The ValueError ``fn`` raises (its message), or '' when it does not."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def engine_cases(cases: dict) -> dict:
    """tests/test_torch_parallel.py's cases on a world of 4."""
    out = {"rank": dist.get_rank()}

    # MultiStreamEngine: scan on (4, 1) and (2, 2) meshes, scan_parallel on (2, 2)
    for name in ("dp", "dpmp", "scanpar"):
        c = cases[name]
        net = net_of(c["layers"], 16, 16, 0.01, c["mode"])
        params = params_from_jax(c["params"], CPU)
        eng = MultiStreamEngine(net, make_mesh(*c["mesh"], device=CPU))
        chunks = chunks_of(c["chunks"])  # [T, S, E]
        fn = eng.scan_parallel if c["mode"] == "full" else eng.scan
        _, outs = fn(eng.place_params(params), eng.init_states(params, 4),
                     eng.place_chunks(chunks, leading_time=True))
        out[name] = _np(eng.gather(outs))

    # TimeShardEngine on 4 ranks: two chained dispatches
    c = cases["ts"]
    net = net_of(c["layers"], 16, 16, 0.05, "full")
    params = params_from_jax(c["params"], CPU)
    eng = TimeShardEngine(net, make_time_mesh(4, device=CPU))
    st = net.init_state(params, CPU)
    for k, planes in enumerate(c["streams"]):
        st, outs = eng.scan_parallel(params, st, chunks_of(planes))
        out[f"ts_outs{k}"] = _np(eng.gather(outs))
        out[f"ts_surface{k}"] = _np(st[0].surface)
        out[f"ts_prev_ts{k}"] = int(st[0].prev_ts)

    # the 2-channel polarity surface, and the refusals
    c = cases["pol"]
    net = net_of(c["layers"], 16, 16, 0.05, "full")
    params = params_from_jax(c["params"], CPU)
    mesh = make_time_mesh(4, device=CPU)
    eng = TimeShardEngine(net, mesh)
    stream = chunks_of(c["stream"])
    st, outs = eng.scan_parallel(params, net.init_state(params, CPU), stream)
    out["pol_outs"] = _np(eng.gather(outs))
    out["pol_surface"] = _np(st[0].surface)
    bad = EventChunk(*(f[:7] for f in stream))
    out["err_t"] = _raises(lambda: eng.scan_parallel(params, net.init_state(params, CPU), bad))
    dense = net_of(OrderedDict(conv1=[3, 3, 1, 8]), 16, 16, 0.05, "dense")
    out["err_mode"] = _raises(lambda: TimeShardEngine(dense, mesh))
    out["err_axis"] = _raises(lambda: TimeShardEngine(net, mesh, axis="data"))

    # dp x sp on a (data, time) mesh of 2 x 2
    c = cases["dpsp"]
    net = net_of(c["layers"], 16, 16, 0.05, "full")
    params = params_from_jax(c["params"], CPU)
    mesh = make_time_mesh(4, n_streams=2, device=CPU)
    eng = TimeShardEngine(net, mesh, stream_axis="data")
    chunks = chunks_of(c["chunks"])  # [S, T, E]
    base = net.init_state(params, CPU)
    states = tuple(type(s)(*(f.expand(4, *f.shape) for f in s)) for s in base)
    out["err_s"] = _raises(lambda: eng.scan_parallel(
        params, states, EventChunk(*(f[:3] for f in chunks))))
    st, outs = eng.scan_parallel(params, states, chunks)
    out["dpsp_names"] = list(mesh.mesh_dim_names)
    out["dpsp_outs"] = _np(eng.gather(outs))
    out["dpsp_surface"] = _np(eng.gather_streams(st[0].surface))
    out["dpsp_prev_ts"] = _np(eng.gather_streams(st[0].prev_ts))

    # 20 chained time-sharded dispatches
    c = cases["drift"]
    net = net_of(c["layers"], 16, 16, 0.02, "full")
    params = params_from_jax(c["params"], CPU)
    eng = TimeShardEngine(net, make_time_mesh(4, device=CPU))
    st = net.init_state(params, CPU)
    outs = []
    for planes in c["streams"]:
        st, o = eng.scan_parallel(params, st, chunks_of(planes))
        outs.append(_np(eng.gather(o)))
    out["drift_outs"] = np.stack(outs)
    out["drift_surface"] = _np(st[0].surface)

    # the collectives of one scan_parallel at two T
    c = cases["traffic"]
    net = net_of(c["layers"], 16, 16, 1e-4, "full")
    params = params_from_jax(c["params"], CPU)
    eng = TimeShardEngine(net, make_time_mesh(4, device=CPU))
    for key in ("t32", "t64"):
        eng.time.calls.clear()
        eng.scan_parallel(params, net.init_state(params, CPU), chunks_of(c[key]))
        out[f"traffic_{key}"] = sorted(eng.time.calls.items())

    # the data-parallel Trainer on a (4, 1) mesh
    c = cases["trainer"]
    net = net_of(c["layers"], 16, 16, 1e-4, "dense")
    params = params_from_jax(c["params"], CPU)
    trainer = Trainer(net, 3, 2, (4, 4), mesh=make_mesh(4, 1, device=CPU))
    frames = torch.from_numpy(c["frames"])
    targets = YoloTargets(*(torch.from_numpy(a) for a in c["targets"]))
    params, opt, loss = trainer.step(params, trainer.init(params), frames, targets)
    out["train_loss"] = float(loss)
    out["train_params"] = {k: _np(v) for k, v in params.items()}
    out["train_adam"] = {k: _np(opt.state[params[k]]["exp_avg_sq"]) for k in params}
    out["err_batch"] = _raises(lambda: trainer.step(params, opt, frames[:6],
                                                    YoloTargets(*(t[:6] for t in targets))))
    return out


def serving_cases(c: dict) -> dict:
    """tests/test_torch_parallel_serving.py's mesh pipeline on a world of 4:
    S = 4 streams on a (2, 2) mesh, two dispatches."""
    net = net_of(c["dsl"], 16, 16, 1e-4, "full")
    params = params_from_jax(c["params"], CPU)
    mesh = make_mesh(2, 2, device=CPU)
    pipe = StreamingPipeline(net, params, capacity=c["cap"], streams=4, mesh=mesh)
    mine = list(pipe.serve(list(c["items"])))
    got = pipe.gather_results(mine)
    eng = pipe._engine
    return {
        "rank": dist.get_rank(),
        "own": [(r.n_events, tuple(r.outputs.shape)) for r in mine],
        "outputs": [_np(r.outputs) for r in got],
        "n_events": [r.n_events for r in got],
        "counts": [r.counts for r in got],
        "surface": _np(eng.gather(pipe.state[0].surface, dim=0)),
        "prev_ts": _np(eng.gather(pipe.state[0].prev_ts, dim=0)),
        "err_div": _raises(lambda: StreamingPipeline(net, params, capacity=c["cap"],
                                                     streams=3, mesh=mesh)),
        "err_one": _raises(lambda: StreamingPipeline(net, params, capacity=c["cap"],
                                                     streams=1, mesh=mesh)),
        # data rank 0's streams get 1 chunk, data rank 1's 3: every rank raises
        "err_t": _raises(lambda: list(StreamingPipeline(
            net, params, capacity=c["cap"], streams=4, mesh=mesh).serve(c["uneven"]))),
    }


def stuck_rank(seconds: float) -> None:
    """Rank 0 waits in a collective of the ``model`` axis of a 1 x 2 mesh
    that rank 1 never joins; the port's group timeout
    (``parallel.mesh.TIMEOUT``) is set to ``seconds`` here, in the rank,
    before the mesh starts its groups."""
    import time
    from datetime import timedelta

    from async_ev_cnn_torch.parallel import mesh as pmesh

    pmesh.TIMEOUT = timedelta(seconds=seconds)
    model = pmesh.Comm(make_mesh(1, 2, device=CPU).get_group("model"), torch.device(CPU))
    if dist.get_rank() == 0:
        model.sum(torch.zeros(1))
    else:
        time.sleep(60 * seconds)
