"""The multi-device dry run: every sharded path of the port on ``n`` ranks
at small shapes, each held against the unsharded path.

    python -m async_ev_cnn_torch.parallel.dryrun 8 --device cpu   # 8 gloo ranks on the CPU
    python -m async_ev_cnn_torch.parallel.dryrun 4                # 4 gloo ranks on the card

Counterpart of ``__graft_entry__.dryrun_multichip``, with its legs and
shapes (a 32x32 frame, its layer DSL, ``n_model=2`` where ``n`` is even):
1 the multi-stream ``step`` (streams over ``data``, conv channels over
``model``), 1b ``scan_parallel`` over the mesh, 1c one stream's time axis
over all ``n`` ranks, 1d streams x time on a ``(2, n/2)`` mesh, 1e the
mesh serving pipeline against the unsharded one, 2 the data-parallel
training step against the unsharded one.  Each leg holds within 1e-5, as
there.  Without a device the ranks run on the card with gloo (several
ranks share one card only through gloo); with ``--device cpu`` on the
CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from async_ev_cnn_torch.layers.network import EventNetwork
from async_ev_cnn_torch.layers.types import EventChunk
from async_ev_cnn_torch.models.train import Trainer, YoloTargets
from async_ev_cnn_torch.parallel.launch import launch
from async_ev_cnn_torch.parallel.mesh import make_mesh, make_time_mesh, mesh_device
from async_ev_cnn_torch.parallel.streams import MultiStreamEngine
from async_ev_cnn_torch.parallel.time_shard import TimeShardEngine
from async_ev_cnn_torch.utils.config import layers_dict
from async_ev_cnn_torch.utils.device import resolve_device
from async_ev_cnn_torch.utils.serving import StreamingPipeline
from async_ev_cnn_torch.utils.weights import params_from_jax

DSL = ("conv1=3,3,1,8 pool1=2,2 conv2=3,3,8,16 pool2=2,2 "
       "conv3=1,1,16,32 conv4=1,1,32,12")
TOL = 1e-5
LEGS = ("1", "1b", "1c", "1d", "1e", "2")


def _build(device, conv_mode="dense"):
    """The dry run's network at 32x32 and its seeded weights (the JAX
    entry's: ``make_params`` of ``RandomState(0)``, HWIO scaled by 0.05)."""
    defs = layers_dict(DSL)
    net = EventNetwork(defs, 32, 32, leak=1e-4, alpha=0.1, padding="SAME",
                       conv_mode=conv_mode)
    rng = np.random.RandomState(0)
    hwio = {}
    for name, size in defs.items():
        if "conv" in name:
            hwio[f"w_{name}"] = rng.randn(*size[:2], size[2], size[3]).astype(np.float32) * 0.05
            hwio[f"b_{name}"] = rng.randn(size[3]).astype(np.float32) * 0.05
    return net, params_from_jax(hwio, device)


def _chunk(rng, device, n=16, capacity=16):
    ts = np.sort(rng.randint(1, 50, size=n)).astype(np.int32)
    return EventChunk.from_arrays(rng.randint(0, 32, n), rng.randint(0, 32, n), ts,
                                  capacity=capacity, device=device)


def _stack(chunks):
    return EventChunk(*(torch.stack(f) for f in zip(*chunks)))


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _legs(n: int, device: str) -> dict:
    """One rank's legs; returns the largest error of each."""
    if dist.get_world_size() != n:
        raise ValueError(f"dry run for {n} ranks in a world of {dist.get_world_size()}")
    errs = {}
    n_model = 2 if n % 2 == 0 else 1
    mesh = make_mesh(n_data=n // n_model, n_model=n_model, device=device)
    dev = mesh_device(mesh)
    net, params = _build(dev)
    eng = MultiStreamEngine(net, mesh)
    n_streams = eng.n_data * 2  # 2 streams a data shard
    rng = np.random.RandomState(2)

    # 1) the multi-stream step: streams over data, conv channels over model
    chunks = _stack([_chunk(rng, dev) for _ in range(n_streams)])
    p = eng.place_params(params)
    _, outs = eng.step(p, eng.init_states(params, n_streams), eng.place_chunks(chunks))
    outs = eng.gather(outs, dim=0)
    ref = torch.stack([net.step(params, net.init_state(params, dev),
                                EventChunk(*(f[s] for f in chunks)))[1]
                       for s in range(n_streams)])
    errs["1"] = _err(outs, ref)

    # 1b) parallel-in-time serving over the mesh: T = 2 copies of the chunks
    net_f, _ = _build(dev, "full")
    eng_f = MultiStreamEngine(net_f, mesh)
    chunks_ts = EventChunk(*(torch.stack([f, f]) for f in chunks))
    _, outs_f = eng_f.scan_parallel(eng_f.place_params(params),
                                    eng_f.init_states(params, n_streams),
                                    eng_f.place_chunks(chunks_ts, leading_time=True))
    outs_f = eng_f.gather(outs_f)
    ref_f = torch.stack([net_f.scan_parallel(params, net_f.init_state(params, dev),
                                             EventChunk(*(f[:, s] for f in chunks_ts)))[1]
                         for s in range(n_streams)], dim=1)
    errs["1b"] = _err(outs_f, ref_f)

    # 1c) sequence parallelism: one stream's time axis over every rank
    eng_t = TimeShardEngine(net_f, make_time_mesh(n, device=device))
    t_chunks = _stack([_chunk(rng, dev) for _ in range(2 * n)])
    st_t, outs_t = eng_t.scan_parallel(params, net_f.init_state(params, dev), t_chunks)
    outs_t = eng_t.gather(outs_t)
    st_ref, outs_ref = net_f.scan_parallel(params, net_f.init_state(params, dev), t_chunks)
    errs["1c"] = max(_err(outs_t, outs_ref), _err(st_t[0].surface, st_ref[0].surface))

    # 1d) dp x sp: streams x time on a (data, time) mesh
    if n % 2 == 0:
        eng_dt = TimeShardEngine(net_f, make_time_mesh(n, n_streams=2, device=device),
                                 stream_axis="data")
        base = net_f.init_state(params, dev)
        states_dt = tuple(type(st)(*(f.expand(2, *f.shape) for f in st)) for st in base)
        chunks_dt = EventChunk(*(torch.stack([f[:n], f[n:]]) for f in t_chunks))
        _, outs_dt = eng_dt.scan_parallel(params, states_dt, chunks_dt)
        outs_dt = eng_dt.gather(outs_dt)
        ref_dt = torch.stack([net_f.scan_parallel(params, base,
                                                  EventChunk(*(f[s] for f in chunks_dt)))[1]
                              for s in range(2)])
        errs["1d"] = _err(outs_dt, ref_dt)

    # 1e) the mesh serving pipeline against the unsharded one
    items = []
    for _ in range(2 * n_streams):  # 2 dispatches of n_streams items
        ts = np.sort(rng.randint(1, 50, size=24)).astype(np.int32)
        items.append(np.stack([rng.randint(0, 32, 24), rng.randint(0, 32, 24), ts],
                              axis=-1))
    want = list(StreamingPipeline(net_f, params, capacity=16, streams=n_streams,
                                  device=dev).serve(list(items)))
    pipe = StreamingPipeline(net_f, params, capacity=16, streams=n_streams, mesh=mesh)
    got = pipe.gather_results(pipe.serve(list(items)))
    if len(got) != len(want) or len(got) != 2:
        raise RuntimeError(f"mesh pipeline served {len(got)} dispatches, unsharded {len(want)}")
    errs["1e"] = max(_err(g.outputs, w.outputs) for g, w in zip(got, want))

    # 2) the data-parallel training step against the unsharded one
    out_c, sh, sw = net.out_shape
    num_bbox = 2
    num_classes = out_c - num_bbox * 5
    batch = eng.n_data * 2
    frames = torch.from_numpy(rng.rand(batch, 32, 32).astype(np.float32)).to(dev)
    boxes = torch.zeros((batch, sh, sw, 4), device=dev)
    boxes[:, 0, 0] = torch.tensor([0.5, 0.5, 0.2, 0.2])
    obj = torch.zeros((batch, sh, sw), device=dev)
    obj[:, 0, 0] = 1.0
    targets = YoloTargets(boxes, obj, torch.zeros((batch, sh, sw), dtype=torch.int64,
                                                  device=dev))
    losses, new = [], []
    for m in (mesh, None):
        trainer = Trainer(net, num_classes, num_bbox, (sh, sw), mesh=m)
        p_t = {k: v.clone() for k, v in params.items()}
        p_t, _, loss = trainer.step(p_t, trainer.init(p_t), frames, targets)
        losses.append(loss)
        new.append(p_t)
    errs["2"] = max([_err(losses[0], losses[1])]
                    + [_err(new[0][k].detach(), new[1][k].detach()) for k in params])
    return errs


def dryrun_multichip(n: int, device: str | None = None, verbose: bool = True) -> dict:
    """Spawn ``n`` gloo ranks (on ``device``: the card when not given) and
    run every leg; raises if a leg on any rank is off by more than
    :data:`TOL` from the unsharded path.  Returns the legs' largest errors
    over the ranks and the wall time."""
    where = resolve_device(device).type  # the card when not given; raises without one
    t0 = time.perf_counter()
    per_rank = launch(_legs, n, args=(n, where), backend="gloo")
    errs = {leg: max(r[leg] for r in per_rank) for leg in per_rank[0]}
    wall = time.perf_counter() - t0
    if verbose:
        print(f"dryrun: {n} gloo ranks on {where}, "
              + ", ".join(f"leg {k} {v:.3e}" for k, v in errs.items())
              + f" (tolerance {TOL}), {wall:.1f} s")
    bad = {k: v for k, v in errs.items() if not v <= TOL}
    if bad:
        raise RuntimeError(f"dry run legs off the unsharded path: {bad}")
    return {"errors": errs, "seconds": wall}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, help="ranks")
    ap.add_argument("--device", default=None, help="'cpu', or the card when not given")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
