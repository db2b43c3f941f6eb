"""The paper's incremental engine: ``models/yolo.YoloEventTorch.step``.  A
request is one chunk, handed over from the host as
``EventChunk.from_arrays`` builds it.  Completion is a CUDA event recorded
after ``step``."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import harness as h
from portbench.inputs import make_weights
from portbench.reference import efcn as ref

#: chunks sampled for the comparison, besides the last
SAMPLE = 32
#: chunks a block of the reference's surface chain
REF_CHUNKS = 256


class Engine:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device, traffic):
        from async_ev_cnn_torch.models.yolo import YoloEventTorch
        from async_ev_cnn_torch.ops.conv import set_matmul_precision

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        if int(mix["streams"]) != 1 or int(mix["chunks"]) != 1 or (
                int(mix["events_per_chunk"]) != cfg["events_per_chunk"]):
            raise ValueError("a step mix's requests are one chunk of one stream")
        set_matmul_precision(cfg["matmul_precision"])
        self.traffic = traffic
        self.clock = h.Clock(device)
        self.model = YoloEventTorch(
            h_frame=cfg["frame_h"], w_frame=cfg["frame_w"], num_classes=cfg["num_classes"],
            cnn_layers=cfg["layers"], cnn_padding=cfg["padding"], h_cells=cfg["h_cells"],
            w_cells=cfg["w_cells"], num_bbox=cfg["num_bbox"], alpha=cfg["alpha"],
            leak=cfg["leak"], conv_mode=cfg["conv_mode"],
            capacity_frac=cfg["capacity_frac"], stem_fusion=cfg["stem_fusion"],
            activation_dtype=cfg["activation_dtype"], device=device)
        self.model.params.update(make_weights(cfg["layers"], seed, device))
        self.state = self.model.init_state()

    def _chunk(self, ev):
        from async_ev_cnn_torch.layers.types import EventChunk

        return EventChunk.from_arrays(ev[:, 0], ev[:, 1], ev[:, 2],
                                      capacity=self.cfg["events_per_chunk"],
                                      device=self.device)

    def warm_up(self) -> None:
        for k in range(self.traffic.warmup):
            self.state, grid = self.model.step(self.state, self._chunk(self.traffic.item(k, 0)))
        float(grid.sum())
        self.model.net.reset_counts()

    def run(self, seconds: float, tracer=None) -> h.Record:
        tr = self.traffic
        sample = h.Sample(SAMPLE, self.seed)
        self.clock.anchor()
        rec = h.Record(seconds=seconds, t_start=time.perf_counter())
        t_end = rec.t_start + seconds
        k = tr.warmup
        back = None
        switch = h.TraceSwitch(tracer, rec)
        while True:
            t_in = time.perf_counter()
            switch.poll(t_in)
            with switch.source_range():
                if back is not None:
                    rec.host_gaps_s.append(t_in - back)
                if t_in >= t_end:
                    break
                j = k - tr.warmup
                ev = tr.item(k, 0)
            back = time.perf_counter()
            req = h.Request(back, len(ev), 1)
            self.state, grid = self.model.step(self.state, self._chunk(ev))
            req.mark = self.clock.mark()
            rec.requests.append(req)
            sample.offer(j)
            sample.put(j, "outputs", grid)
            sample.put(j, "surface", self.state[0].surface)
            k += 1
        switch.close()
        for r in rec.requests:
            r.done = self.clock.seconds(r.mark)
            r.mark = None
        counts = {}
        for c in self.model.net.layer_counts.values():
            for key, n in c.items():
                counts[key] = counts.get(key, 0) + n
        counts["conv_calls"] = len(rec.requests) * len(self.model.net.layer_counts)
        counts["chunks"] = len(rec.requests)
        rec.counters = counts
        self.sample = sample
        return rec

    def compare(self, control: bool = False):
        """As the serving engine's ``compare``, for each sampled chunk's grid
        and surface: the incremental engine's against the dense reference on
        the reference's surface."""
        cfg, tr = self.cfg, self.traffic
        chosen = self.sample.chosen()
        self.model = self.state = None
        h.free(self.device)
        weights = make_weights(cfg["layers"], self.seed, self.device)
        shape = (1, cfg["frame_h"], cfg["frame_w"], cfg["leak"], self.device)
        chain = ref.SurfaceChain(*shape)
        low = ref.SurfaceChain(*shape, dtype=torch.bfloat16) if control else None
        prog = {"out_gap": 0.0, "surface_gap": 0.0}
        ctrl = dict(prog) if control else None
        n = tr.warmup + max(chosen, default=-1) + 1
        for a in range(0, n, REF_CHUNKS):
            ks = range(a, min(n, a + REF_CHUNKS))
            y, x, ts, valid = h.chunks([np.concatenate([tr.item(k, 0) for k in ks])],
                                       len(ks), cfg["events_per_chunk"], self.device)
            keep = [i for i, k in enumerate(ks) if k - tr.warmup in chosen]
            surfaces = chain.run(y, x, ts, valid, keep)[0]
            low_s = low.run(y, x, ts, valid, keep)[0] if control else None
            if not keep:
                continue
            grid = h.grid(surfaces[:, None], weights, cfg)
            low_grid = h.grid(surfaces[:, None], weights, cfg, use_tf32=True) if control else None
            for i, at in enumerate(keep):
                got = chosen[ks[at] - tr.warmup]
                h.fold(prog, [(got["outputs"], grid[i])],
                       got["surface"].reshape(surfaces[i].shape), surfaces[i])
                if control:
                    h.fold(ctrl, [(low_grid[i], grid[i])], low_s[i], surfaces[i])
        return prog, ctrl
