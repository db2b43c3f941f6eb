"""The serving engine: ``utils/serving.StreamingPipeline`` over
``EventNetwork.scan_parallel`` (every layer 'full'), the serve CLI's
deployment.  A request is one dispatch: an item of ``chunks`` chunks from
each of ``streams`` streams.  Completion is a CUDA event recorded in the
pipeline's ``postprocess``, after the head's decoding."""

from __future__ import annotations

import time

import torch

from portbench import harness as h
from portbench.inputs import make_weights
from portbench.reference import efcn as ref

#: dispatches sampled for the comparison, besides the last
SAMPLE = 6
#: an open loop hands over requests due in the window until this long after
#: its close; what is still due then is the backlog, and counts as failed
GRACE_S = 2.0


class Engine:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device, traffic):
        from async_ev_cnn_torch.layers.network import EventNetwork
        from async_ev_cnn_torch.models import head
        from async_ev_cnn_torch.ops.conv import set_matmul_precision
        from async_ev_cnn_torch.utils.serving import StreamingPipeline

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        if int(mix["chunks"]) != cfg["serve_chunks"] or (
                int(mix["events_per_chunk"]) != cfg["events_per_chunk"]):
            raise ValueError("a serve mix's items must hold serve_chunks chunks of "
                             "events_per_chunk events")
        set_matmul_precision(cfg["matmul_precision"])
        self.traffic = traffic
        self.clock = h.Clock(device)
        net = EventNetwork(cfg["layers"], cfg["frame_h"], cfg["frame_w"], cfg["leak"],
                           cfg["alpha"], cfg["padding"], conv_mode=cfg["conv_mode"],
                           stem_fusion=cfg["stem_fusion"],
                           activation_dtype=cfg["activation_dtype"])
        params = make_weights(cfg["layers"], seed, device)
        nc, nb = cfg["num_classes"], cfg["num_bbox"]

        def post(outs):  # the serve CLI's decoding, and the completion mark
            boxes, _, probs = head.decode(outs, nc, nb, cfg["frame_h"], cfg["frame_w"])
            return outs, boxes, probs, self.clock.mark()

        self.pipe = StreamingPipeline(
            net, params, capacity=cfg["events_per_chunk"], streams=traffic.streams,
            max_in_flight=cfg["max_in_flight"], wire=cfg["wire"], postprocess=post,
            t_chunks=cfg["serve_chunks"], device=device)

    def _group(self, k: int):
        return [self.traffic.item(k, s) for s in range(self.traffic.streams)]

    def warm_up(self) -> None:
        for k in range(self.traffic.warmup):
            for _ in self.pipe.serve(self._group(k)):
                pass
        self.pipe.stats.update(dispatches=0, wire_bytes=0, events=0)

    def run(self, seconds: float, tracer=None) -> h.Record:
        tr, pipe = self.traffic, self.pipe
        sample = h.Sample(SAMPLE, self.seed)
        self.clock.anchor()
        rec = h.Record(seconds=seconds, t_start=time.perf_counter())
        t_end = rec.t_start + seconds
        frames = tr.streams * tr.chunks
        state = {"back": None}
        switch = h.TraceSwitch(tracer, rec)

        def source():
            k = tr.warmup
            while True:
                t_in = time.perf_counter()
                switch.poll(t_in)
                with switch.source_range():
                    j = k - tr.warmup
                    if state["back"] is not None:
                        rec.host_gaps_s.append(t_in - state["back"])
                    if j:  # the pipeline has dispatched request j - 1
                        sample.put(j - 1, "surface", pipe.state[0].surface)
                    if tr.open_loop:
                        due = rec.t_start + tr.due_s(k)
                        if due > t_end:
                            return
                        if t_in >= t_end + GRACE_S:  # the rest due form the backlog
                            while rec.t_start + tr.due_s(k) <= t_end:
                                rec.backlog += 1
                                k += 1
                            return
                        h.wait_until(due)
                    elif t_in >= t_end:
                        return
                    t_take = time.perf_counter()
                    if tr.open_loop:
                        rec.lateness_s.append(t_take - due)
                    else:
                        due = t_take
                    group = self._group(k)
                    rec.requests.append(h.Request(due, sum(len(g) for g in group), frames))
                    sample.offer(j)
                for i, item in enumerate(group):
                    if i == len(group) - 1:  # the pipeline takes over from here
                        state["back"] = time.perf_counter()
                    yield item
                k += 1

        for j, res in enumerate(pipe.serve(source())):
            outs, boxes, probs, mark = res.outputs
            rec.requests[j].mark = mark
            sample.put(j, "outputs", (outs, boxes, probs))
        switch.close()
        if rec.requests:
            sample.put(len(rec.requests) - 1, "surface", pipe.state[0].surface)
        for r in rec.requests:
            r.done = self.clock.seconds(r.mark)
            r.mark = None
        rec.counters = dict(pipe.stats)
        self.sample = sample
        return rec

    def compare(self, control: bool = False):
        """The numbers ``correct`` compares, against the reference:
        ``out_gap`` (each sampled dispatch's grids, decoded boxes and
        probabilities) and ``surface_gap`` (its end surfaces), each the
        largest ``max|program - reference| / max|reference|`` over the
        sample.  Returns the program's and, with ``control``, the same
        numbers of the control: the reference in the next lower precision
        in the program's place (TF32 convolutions, bfloat16 surfaces)."""
        cfg, tr = self.cfg, self.traffic
        chosen = self.sample.chosen()
        self.pipe = None  # the program's state goes before the reference runs
        h.free(self.device)
        weights = make_weights(cfg["layers"], self.seed, self.device)
        shape = (tr.streams, cfg["frame_h"], cfg["frame_w"], cfg["leak"], self.device)
        chain = ref.SurfaceChain(*shape)
        low = ref.SurfaceChain(*shape, dtype=torch.bfloat16) if control else None
        prog = {"out_gap": 0.0, "surface_gap": 0.0}
        ctrl = dict(prog) if control else None
        heads = (cfg["num_classes"], cfg["num_bbox"], cfg["frame_h"], cfg["frame_w"])
        for k in range(tr.warmup + max(chosen, default=-1) + 1):
            j = k - tr.warmup
            y, x, ts, valid = h.chunks(self._group(k), tr.chunks, cfg["events_per_chunk"],
                                       self.device)
            keep = range(tr.chunks) if j in chosen else ()
            surfaces = chain.run(y, x, ts, valid, keep)
            low_s = low.run(y, x, ts, valid, keep) if control else None
            if j not in chosen:
                continue
            frames = surfaces.reshape(-1, 1, cfg["frame_h"], cfg["frame_w"])
            grid = h.grid(frames, weights, cfg)
            want = (grid, *ref.decode(grid, *heads))
            outs, boxes, probs = chosen[j]["outputs"]
            h.fold(prog, zip((outs, boxes, probs), want),
                   chosen[j]["surface"].reshape(surfaces[:, -1].shape), surfaces[:, -1])
            if control:
                low_grid = h.grid(frames, weights, cfg, use_tf32=True)
                h.fold(ctrl, zip((low_grid, *ref.decode(low_grid, *heads)), want),
                       low_s[:, -1], surfaces[:, -1])
        return prog, ctrl
