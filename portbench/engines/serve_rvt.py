"""The serving engine of RVT (a recurrent vision transformer with a YOLOX
head): ``utils/serving.StreamingPipeline`` over ``EventNetwork.
scan_parallel``, as the serve CLI runs ``configs/rvt_base_event.yml``.  As
``serve_yolo.py``, with the network built from the port's layer DSL,
seeded weights whose batch norm the port folds at load
(``utils/weights.fold_batchnorm``, PyTorch's form), YOLOX's decode of the
three levels on the card and its own reference (``reference/rvt.py``).

A request is one dispatch; completion is a CUDA event recorded in the
pipeline's ``postprocess``, after the decoding.  The network carries each
LSTM's ``(h, c)`` from dispatch to dispatch, so the comparison checks the
carried state: for each sampled dispatch ``j`` the reference starts from
the program's LSTM states at the start of dispatch ``j - 1`` (taken when
the program handed over ``j - 1``) and runs ``j - 1`` and ``j`` with its
own state, one chunk-boundary surface at a time.  Closed loops only."""

from __future__ import annotations

import time

import torch

from portbench import harness as h
from portbench.engines import serve
from portbench.engines.serve_yolo import compared
from portbench.reference import efcn as surfaces_ref
from portbench.reference import rvt as ref

#: dispatches sampled for the comparison, besides the last: each costs the
#: reference two dispatches, time step by time step
SAMPLE = 3


def layers_dsl(cfg: dict) -> str:
    """The configuration's layers in the port's layer DSL."""
    suffix = {**{n: "@linear" for n in cfg["linear"]}, **{n: "@silu" for n in cfg["silu"]}}
    return " ".join(f"{name}={','.join(map(str, size))}{suffix.get(name, '')}"
                    for name, size in cfg["layers"].items())


def architecture(cfg: dict) -> dict:
    """The reference's architecture at the configuration's widths."""
    return ref.architecture(cfg["input_channels"], cfg["embed_dim"], cfg["stage_dims"],
                            cfg["dim_head"], cfg["partition"], cfg["mlp_ratio"],
                            cfg["fpn_depth"], cfg["num_classes"])


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The reference's seeded weights (``reference/rvt.make_weights``)."""
    return ref.make_weights(architecture(cfg), seed, device)


class Engine(serve.Engine):
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device, traffic):
        from async_ev_cnn_torch.layers.network import EventNetwork
        from async_ev_cnn_torch.models.head import decode_yolox
        from async_ev_cnn_torch.ops.conv import set_matmul_precision
        from async_ev_cnn_torch.utils.config import layers_dict
        from async_ev_cnn_torch.utils.serving import StreamingPipeline
        from async_ev_cnn_torch.utils.weights import fold_batchnorm

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        if int(mix["chunks"]) != cfg["serve_chunks"] or (
                int(mix["events_per_chunk"]) != cfg["events_per_chunk"]):
            raise ValueError("a serve mix's items must hold serve_chunks chunks of "
                             "events_per_chunk events")
        if mix["loop"] != "closed":
            raise ValueError("the RVT engine serves a closed loop")
        self.net = net = EventNetwork(
            layers_dict(layers_dsl(cfg)), cfg["frame_h"], cfg["frame_w"], cfg["leak"],
            cfg["alpha"], cfg["padding"], conv_mode=cfg["conv_mode"],
            stem_fusion=cfg["stem_fusion"], activation_dtype=cfg["activation_dtype"])
        set_matmul_precision(cfg["matmul_precision"])
        self.traffic = traffic
        self.clock = h.Clock(device)
        params = fold_batchnorm(make_weights(cfg, seed, device), eps=ref.BN_EPS, form="torch")
        strides = net.head_strides
        #: each LSTM's index in the network's state
        self.lstm_at = [1 + i for i, ld in enumerate(net.event_layers[1:]) if ld.kind == "lstm"]

        def post(outs):  # the serve CLI's decoding of the levels, and the completion mark
            boxes, _, probs = decode_yolox(outs, strides)
            return outs, boxes, probs, self.clock.mark()

        self.pipe = StreamingPipeline(
            net, params, capacity=cfg["events_per_chunk"], streams=traffic.streams,
            max_in_flight=cfg["max_in_flight"], wire=cfg["wire"], postprocess=post,
            t_chunks=cfg["serve_chunks"], device=device)
        #: the program's LSTM states at the start of a dispatch, by its number
        self.starts: dict = {}

    def _lstm_states(self) -> list:
        st = self.pipe.state
        return [(st[i].h, st[i].c) for i in self.lstm_at]

    def warm_up(self) -> None:
        for k in range(self.traffic.warmup):
            if k == self.traffic.warmup - 1:  # the start of dispatch -1
                self.starts[-1] = self._lstm_states()
            for _ in self.pipe.serve(self._group(k)):
                pass
        self.pipe.stats.update(dispatches=0, wire_bytes=0, events=0)
        self.net.reset_counts()

    def run(self, seconds: float, tracer=None) -> h.Record:
        tr, pipe = self.traffic, self.pipe
        sample = h.Sample(SAMPLE, self.seed)
        self.clock.anchor()
        rec = h.Record(seconds=seconds, t_start=time.perf_counter())
        t_end = rec.t_start + seconds
        frames = tr.streams * tr.chunks
        state = {"back": None, "start": self.starts.pop(-1)}
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
                    if t_in >= t_end:
                        return
                    due = time.perf_counter()
                    group = self._group(k)
                    rec.requests.append(h.Request(due, sum(len(g) for g in group), frames))
                    sample.offer(j)
                    # the program's states at the start of j - 1 and of j
                    sample.put(j, "start", state["start"])
                    state["start"] = self._lstm_states()
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
        rec.counters["lstm_steps"] = sum(self.net.layer_counts[ld.name]["recurrent_steps"]
                                         for ld in self.net.event_layers if ld.kind == "lstm")
        self.sample = sample
        return rec

    def compare(self, control: bool = False):
        """The numbers ``correct`` compares, against the reference:
        ``out_gap`` (each sampled dispatch's three levels, its decoded boxes'
        centres, the logarithms of their sizes, and its class scores) and
        ``surface_gap`` (its end surfaces), each the largest ``max|program -
        reference| / max|reference|`` over the sample; with ``control`` also
        those of the reference in the next lower precision (TF32 convs and
        GEMMs, bfloat16 surfaces).  The reference of a sampled dispatch
        ``j`` starts from the program's LSTM states at the start of ``j -
        1``, so ``j`` runs from the reference's own carried state."""
        cfg, tr = self.cfg, self.traffic
        chosen = self.sample.chosen()
        self.pipe = None  # the program's state goes before the reference runs
        h.free(self.device)
        weights = make_weights(cfg, self.seed, self.device)
        arch = architecture(cfg)
        shape = (tr.streams, cfg["frame_h"], cfg["frame_w"], cfg["leak"], self.device)
        chain = surfaces_ref.SurfaceChain(*shape)
        low = surfaces_ref.SurfaceChain(*shape, dtype=torch.bfloat16) if control else None
        prog = {"out_gap": 0.0, "surface_gap": 0.0}
        ctrl = dict(prog) if control else None
        strides = arch["strides"]
        carry = carry_low = None

        def decoded(levels):
            boxes, _, probs = ref.decode(levels, strides)
            return (*levels, *compared(boxes, probs))

        for k in range(tr.warmup + max(chosen, default=-1) + 1):
            j = k - tr.warmup
            y, x, ts, valid = h.chunks(self._group(k), tr.chunks, cfg["events_per_chunk"],
                                       self.device)
            runs = j in chosen or j + 1 in chosen
            keep = range(tr.chunks) if runs else ()
            surfaces = chain.run(y, x, ts, valid, keep)
            low_s = low.run(y, x, ts, valid, keep) if control else None
            if not runs:
                carry = carry_low = None
                continue
            if carry is None:  # j + 1 is sampled: the program's states at the start of j
                carry = carry_low = [(a.contiguous(), b.contiguous())
                                     for a, b in chosen[j + 1]["start"]]
            frames = surfaces[:, :, None]
            levels, carry = ref.forward(weights, arch, frames, carry)
            if control:
                low_levels, carry_low = ref.forward(weights, arch, frames, carry_low,
                                                    use_tf32=True)
            if j not in chosen:
                continue
            want = decoded(levels)
            outs, boxes, probs = chosen[j]["outputs"]
            h.fold(prog, zip((*outs, *compared(boxes, probs)), want),
                   chosen[j]["surface"].reshape(surfaces[:, -1].shape), surfaces[:, -1])
            if control:
                h.fold(ctrl, zip(decoded(low_levels), want), low_s[:, -1], surfaces[:, -1])
        return prog, ctrl

