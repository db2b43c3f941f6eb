"""The serving engine of a YOLOv3 graph (YOLOv3-tiny): ``utils/serving.
StreamingPipeline`` over ``EventNetwork.scan_parallel``, as the serve CLI
runs ``configs/yolov3_tiny_event.yml``.  As ``serve.py``, with the network
built from the port's layer DSL, darknet-form weights whose batch norm the
port folds at load (``utils/weights.fold_batchnorm``), the YOLOv3 decode of
both heads on the card, and its own reference (``reference/yolov3_tiny.py``,
batch norm unfolded).  A request is one dispatch; completion is a CUDA
event recorded in the pipeline's ``postprocess``, after the decoding."""

from __future__ import annotations

import torch

from portbench import harness as h
from portbench.engines import serve
from portbench.reference import efcn as surfaces_ref
from portbench.reference import yolov3_tiny as ref

#: the batch-norm statistics of each conv that has them
BN = ("gamma", "beta", "mean", "var")


def layers_dsl(cfg: dict) -> str:
    """The configuration's layers in the port's layer DSL."""
    linear = set(cfg["linear"])
    return " ".join(f"{name}={','.join(map(str, size))}" + ("@linear" if name in linear else "")
                    for name, size in cfg["layers"].items())


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Seeded darknet-form weights, made on ``device`` from one generator
    (the same seed and device give the same weights): each conv's kernel
    ``w_<name>`` (OIHW) He-normal, ``N(0, 2 / fan_in)``; a batch-normed
    conv's ``gamma_`` and ``var_<name>`` uniform in [0.5, 1.5) and
    ``beta_`` and ``mean_<name>`` ``N(0, 0.1^2)``; a linear conv (a head)
    has its kernel scaled by ``cfg["head_scale"]``, so that the heads'
    logits stay of the order of one, and its bias ``b_<name>``
    ``N(0, 0.1^2)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**64)
    out = {}
    for name, size in cfg["layers"].items():
        if "conv" not in name:
            continue
        kh, kw, cin, cout = size
        fan_in = kh * kw * cin
        out[f"w_{name}"] = torch.randn((cout, cin, kh, kw), generator=gen, device=device) * (
            2.0 / fan_in) ** 0.5
        if name in cfg["linear"]:
            out[f"w_{name}"] *= cfg["head_scale"]
            out[f"b_{name}"] = torch.randn(cout, generator=gen, device=device) * 0.1
            continue
        for stat in BN:
            if stat in ("gamma", "var"):
                v = torch.rand(cout, generator=gen, device=device) + 0.5
            else:
                v = torch.randn(cout, generator=gen, device=device) * 0.1
            out[f"{stat}_{name}"] = v
    return out


class Engine(serve.Engine):
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device, traffic):
        from async_ev_cnn_torch.layers.network import EventNetwork
        from async_ev_cnn_torch.models.head import decode_yolov3
        from async_ev_cnn_torch.ops.conv import set_matmul_precision
        from async_ev_cnn_torch.utils.config import layers_dict
        from async_ev_cnn_torch.utils.serving import StreamingPipeline
        from async_ev_cnn_torch.utils.weights import fold_batchnorm

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        if int(mix["chunks"]) != cfg["serve_chunks"] or (
                int(mix["events_per_chunk"]) != cfg["events_per_chunk"]):
            raise ValueError("a serve mix's items must hold serve_chunks chunks of "
                             "events_per_chunk events")
        net = EventNetwork(layers_dict(layers_dsl(cfg)), cfg["frame_h"], cfg["frame_w"],
                           cfg["leak"], cfg["alpha"], cfg["padding"], conv_mode=cfg["conv_mode"],
                           stem_fusion=cfg["stem_fusion"],
                           activation_dtype=cfg["activation_dtype"])
        set_matmul_precision(cfg["matmul_precision"])
        self.traffic = traffic
        self.clock = h.Clock(device)
        params = fold_batchnorm(make_weights(cfg, seed, device))
        anchors, masks = cfg["anchors"], cfg["masks"]

        def post(outs):  # the serve CLI's decoding of both heads, and the completion mark
            boxes, _, probs = decode_yolov3(outs, anchors, masks, cfg["frame_h"], cfg["frame_w"])
            return outs, boxes, probs, self.clock.mark()

        self.pipe = StreamingPipeline(
            net, params, capacity=cfg["events_per_chunk"], streams=traffic.streams,
            max_in_flight=cfg["max_in_flight"], wire=cfg["wire"], postprocess=post,
            t_chunks=cfg["serve_chunks"], device=device)

    def compare(self, control: bool = False):
        """The numbers ``correct`` compares, against the reference:
        ``out_gap`` (each sampled dispatch's two grids, its decoded boxes'
        centres, the logarithms of their sizes, and its class scores) and
        ``surface_gap`` (its end surfaces), each the largest
        ``max|program - reference| / max|reference|`` over the sample; with
        ``control`` also those of the reference in the next lower precision
        (TF32 convolutions, bfloat16 surfaces).  A box's size is its
        anchor's times ``exp`` of a logit, so sizes are compared as logits
        are, and centres on their own scale, the frame's."""
        cfg, tr = self.cfg, self.traffic
        chosen = self.sample.chosen()
        self.pipe = None  # the program's state goes before the reference runs
        h.free(self.device)
        weights = make_weights(cfg, self.seed, self.device)
        layers = ref.darknet_layers(classes=cfg["num_classes"],
                                    anchors_per_head=len(cfg["masks"][0]))
        shape = (tr.streams, cfg["frame_h"], cfg["frame_w"], cfg["leak"], self.device)
        chain = surfaces_ref.SurfaceChain(*shape)
        low = surfaces_ref.SurfaceChain(*shape, dtype=torch.bfloat16) if control else None
        prog = {"out_gap": 0.0, "surface_gap": 0.0}
        ctrl = dict(prog) if control else None
        heads = (cfg["anchors"], cfg["masks"], cfg["frame_h"], cfg["frame_w"])

        def grids(frames, use_tf32=False):
            blocks = [ref.forward(frames[i:i + h.REF_FRAMES], weights, layers, use_tf32)
                      for i in range(0, frames.shape[0], h.REF_FRAMES)]
            return [torch.cat(parts) for parts in zip(*blocks)]

        def decoded(g):
            boxes, _, probs = ref.decode(g, *heads)
            return (*g, *compared(boxes, probs))

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
            want = decoded(grids(frames))
            outs, boxes, probs = chosen[j]["outputs"]
            h.fold(prog, zip((*outs, *compared(boxes, probs)), want),
                   chosen[j]["surface"].reshape(surfaces[:, -1].shape), surfaces[:, -1])
            if control:
                h.fold(ctrl, zip(decoded(grids(frames, use_tf32=True)), want),
                       low_s[:, -1], surfaces[:, -1])
        return prog, ctrl


def compared(boxes: torch.Tensor, probs: torch.Tensor) -> tuple:
    """Decoded boxes ``[..., 4]`` (centre x, centre y, width, height) and
    class scores as ``correct`` compares them: centres, the logarithms of
    the sizes, scores."""
    return boxes[..., :2], boxes[..., 2:].log(), probs
