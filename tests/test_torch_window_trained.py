"""The port's regression gate for window mode's trained-weights claim: the
twin of tests/test_window_trained.py on async_ev_cnn_torch (slow).

With random weights, leak-driven sign flips make deep-layer active masks
global every chunk, so window mode degenerates to its dense fallback;
with trained weights (the port's Trainer, 50 Adam steps on a blob
target) the active region stays near the object and the windowed conv
takes its window branch.  The observable is the branch predicate, per
conv layer ``bbox(dilate(prev_mask)) < spec.window``, computed from a
'dense' run's masks (masks do not depend on the mode).  Tolerance: window
mode's outputs within 1e-4 of dense mode's on the trained weights, the
async == dense contract.
"""

from collections import OrderedDict

import numpy as np
import pytest
import torch

from async_ev_cnn_torch.layers.network import EventNetwork
from async_ev_cnn_torch.layers.types import EventChunk
from async_ev_cnn_torch.models.train import Trainer, YoloTargets
from async_ev_cnn_torch.ops.integrate import integrate_parallel
from async_ev_cnn_torch.ops.masks import dilate_mask, mask_bounding_box
from async_ev_cnn_torch.utils.config import layers_dict
from async_ev_cnn_torch.utils.equivalence import make_stream

torch.set_num_threads(2)

H = W = 32
LEAK = 2e-4
DSL = "conv1=3,3,1,8 pool1=2,2 conv2=3,3,8,16 pool2=2,2 conv3=1,1,16,12"
GRID = (8, 8)
NUM_CLASSES, NUM_BBOX = 7, 1  # 7 + 1*5 = conv3's 12 output channels


def _init_params(rng, layer_defs):
    """He-initialised kernels (OIHW) and zero biases, drawn as the JAX
    test draws them (HWIO)."""
    params = {}
    for name, size in layer_defs.items():
        if "conv" in name:
            kh, kw, ci, co = size
            w = rng.randn(kh, kw, ci, co).astype(np.float32) * np.sqrt(2.0 / (kh * kw * ci))
            params[f"w_{name}"] = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
            params[f"b_{name}"] = torch.zeros(co, dtype=torch.float32)
    return params


def _train(rng, net, params, steps=50, batch=4):
    trainer = Trainer(net, NUM_CLASSES, NUM_BBOX, GRID)
    opt_state = trainer.init(params)
    ispec = net.event_layers[0].spec
    loss0 = loss = None
    for _ in range(steps):
        frames, boxes, objs, clss = [], [], [], []
        for _ in range(batch):
            chunks = make_stream(rng, 8, 16, H, W, clustered=True, cluster_radius=3,
                                 device="cpu")
            surfs, _ = integrate_parallel(torch.zeros(ispec.out_shape), 0, chunks, LEAK)
            frames.append(surfs[-1, 0])
            box = np.zeros((*GRID, 4), np.float32)
            obj = np.zeros(GRID, np.float32)
            cls = np.zeros(GRID, np.int32)
            obj[4, 4] = 1.0
            box[4, 4] = [0.5, 0.5, 0.3, 0.3]
            boxes.append(box)
            objs.append(obj)
            clss.append(cls)
        targets = YoloTargets(*(torch.from_numpy(np.stack(a)) for a in (boxes, objs, clss)))
        params, opt_state, loss = trainer.step(params, opt_state, torch.stack(frames), targets)
        if loss0 is None:
            loss0 = float(loss)
    return {k: v.detach() for k, v in params.items()}, loss0, float(loss)


def _window_fit_fracs(net_w, net_dense, params, chunks):
    """Per conv layer: the fraction of chunks whose window-branch predicate
    holds, from a 'dense' run's masks."""
    conv_specs = OrderedDict(
        (ld.name, ld.spec) for ld in net_w.event_layers[1:] if ld.kind == "conv")
    prev_of, prev = {}, "intgr"
    for ld in net_w.event_layers[1:]:
        prev_of[ld.name] = prev
        prev = ld.name
    state = net_dense.init_state(params, "cpu")
    fits = []
    for i in range(chunks.y.shape[0]):
        state, ios = net_dense.forward(params, state, EventChunk(*(f[i] for f in chunks)))
        row = []
        for name, spec in conv_specs.items():
            active = dilate_mask(ios[prev_of[name]].mask, spec.ksize, spec.stride, spec.pads)
            y0, x0, y1, x1, _ = mask_bounding_box(active)
            wh, ww = spec.window
            row.append(bool((y1 - y0 < wh) & (x1 - x0 < ww)))
        fits.append(row)
    fits = np.asarray(fits)  # [T, n_convs]
    return OrderedDict((name, float(fits[:, i].mean())) for i, name in enumerate(conv_specs))


@pytest.mark.slow
def test_trained_weights_keep_window_branch_live(rng):
    layer_defs = layers_dict(DSL)
    params0 = _init_params(rng, layer_defs)
    kw = dict(leak=LEAK, alpha=0.1, padding="SAME")
    net_dense = EventNetwork(layer_defs, H, W, conv_mode="dense", **kw)
    net_w = EventNetwork(layer_defs, H, W, conv_mode="window", window_frac=0.5, **kw)
    params, loss0, loss1 = _train(rng, net_dense, {k: v.clone() for k, v in params0.items()})
    assert loss1 < loss0 * 0.5, f"training failed to converge: {loss0} -> {loss1}"

    chunks = make_stream(rng, 60, 16, H, W, clustered=True, cluster_radius=3, device="cpu")
    fr_trained = _window_fit_fracs(net_w, net_dense, params, chunks)
    fr_random = _window_fit_fracs(net_w, net_dense, params0, chunks)
    deep = list(fr_trained)[-1]
    assert fr_trained[deep] >= 0.9, fr_trained
    for name in fr_trained:
        assert fr_trained[name] >= fr_random[name] - 1e-9, (name, fr_trained, fr_random)

    _, outs_w = net_w.scan(params, net_w.init_state(params, "cpu"), chunks)
    _, outs_d = net_dense.scan(params, net_dense.init_state(params, "cpu"), chunks)
    np.testing.assert_allclose(outs_w.numpy(), outs_d.numpy(), atol=1e-4, rtol=0)
