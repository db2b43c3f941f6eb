"""Training: the YOLO grid loss and a dense-frame trainer with Adam.

Counterpart of ``async_ev_cnn_tpu/models/train.py``: the YOLO-v1-style
detection objective over the eFCN grid output and one optimizer step of
the dense frame model (training runs on integrated frames; the async path
is an inference-time execution of the same weights).  Where the JAX
package takes ``jax.value_and_grad`` and steps ``optax.adam``, the port
takes autograd's gradients and steps ``torch.optim.Adam`` with optax's
defaults (betas 0.9 and 0.999, eps 1e-8, no eps_root).  The two order
Adam's arithmetic differently, so after k steps their parameters agree
within rounding, not bit for bit.  No hand-written kernel runs here: the
JAX package computes this path outside any Pallas kernel, and the port's
convs and their gradients are cuDNN's on the card.

On the card a step runs with cuDNN's deterministic algorithms, so that a
resumed run repeats an uninterrupted one bit for bit, and with TF32 as
the matmul tier sets it: autograd runs the backward convs after the
forward has applied the tier, and reads the flags then.  Both are scoped
to the step; the serving path's cuDNN settings do not change.

The optimizer state crosses the packages: :func:`save_adam_state` writes
the leaves of ``optax.adam(lr).init(params)`` as the JAX training CLI
stores them (``utils/checkpoint.save_stream_state``: the int32 count, then
``mu`` and then ``nu`` one leaf a parameter in sorted key order, conv
moments HWIO), and :func:`restore_adam_state` reads them back.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from async_ev_cnn_torch.layers.network import EventNetwork, dense_forward
from async_ev_cnn_torch.ops.conv import _apply_tier
from async_ev_cnn_torch.utils.checkpoint import restore_stream_state, save_stream_state
from async_ev_cnn_torch.utils.weights import params_from_jax, params_to_jax

#: optax.adam's defaults besides the learning rate
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


class YoloTargets(NamedTuple):
    """Per-cell supervision for a ``[S_h, S_w, C + B*5]`` grid.

    Attributes:
      boxes: f32 ``[N, S_h, S_w, 4]`` (x, y in cell units; w, h normalized).
      obj:   f32 ``[N, S_h, S_w]`` 1 where a cell owns an object.
      cls:   int ``[N, S_h, S_w]`` class index (ignored where obj == 0).
    """

    boxes: torch.Tensor
    obj: torch.Tensor
    cls: torch.Tensor


def _one_hot(index: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot, all zeros for an index outside ``[0, n)`` (as
    ``jax.nn.one_hot``; ``F.one_hot`` raises there)."""
    return (index[..., None] == torch.arange(n, device=index.device)).to(torch.float32)


def yolo_loss(
    grid: torch.Tensor,  # [..., S_h, S_w, C + B*5]
    targets: YoloTargets,  # leaves with the same leading axes
    num_classes: int,
    num_bbox: int,
    lambda_coord: float = 5.0,
    lambda_noobj: float = 0.5,
) -> torch.Tensor:
    """YOLO-v1 sum-squared grid loss (sqrt-encoded w/h, responsible-box
    selection by predicted confidence), one value per grid: a scalar for
    one ``[S_h, S_w, C + B*5]`` grid, ``[N]`` for a batch of them.  The
    JAX package's arithmetic; the responsible box is the first
    highest-confidence predictor of a cell, a constant of the gradient."""
    sh, sw = grid.shape[-3:-1]
    lead = grid.shape[:-3]
    cls_pred = grid[..., :num_classes]
    box = grid[..., num_classes:].reshape(*lead, sh, sw, num_bbox, 5)
    conf = box[..., 4]

    # responsible box = highest-confidence predictor in the cell
    resp = _one_hot(conf.detach().argmax(dim=-1), num_bbox)  # [..., S, S, B]

    tgt_xy = targets.boxes[..., :2]
    tgt_wh_sqrt = torch.sqrt(torch.clamp(targets.boxes[..., 2:4], min=1e-8))
    pred_xy = box[..., 0:2]
    pred_wh = box[..., 2:4]  # stored sqrt-encoded

    def total(x):  # the sum over each grid
        return x.reshape(*lead, -1).sum(dim=-1)

    obj = targets.obj[..., None]  # [..., S, S, 1]
    coord = total(
        resp[..., None] * obj[..., None, :]
        * (torch.square(pred_xy - tgt_xy[..., None, :])
           + torch.square(pred_wh - tgt_wh_sqrt[..., None, :]))
    )
    conf_obj = total(resp * obj * torch.square(conf - 1.0))
    conf_noobj = total((1.0 - resp * obj) * torch.square(conf))
    cls_tgt = _one_hot(targets.cls, num_classes)
    cls_loss = total(targets.obj[..., None] * torch.square(cls_pred - cls_tgt))
    return lambda_coord * coord + conf_obj + lambda_noobj * conf_noobj + cls_loss


@contextlib.contextmanager
def _step_flags(device: torch.device):
    """cuDNN's deterministic algorithms, no autotuning, and the tier's TF32
    flags for one step on the card; the previous cuDNN flags after it."""
    if device.type != "cuda":
        yield
        return
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    _apply_tier()
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


class Trainer:
    """Dense-frame YOLO trainer over the same layer specs as the async net.

    Parameters are the port's tensors (OIHW conv kernels) in a dict;
    :meth:`init` makes them leaf tensors that require grad and returns the
    optimizer, the JAX package's ``opt_state``.  :meth:`step` updates the
    tensors in place and returns ``(params, opt_state, loss)`` as the JAX
    step does.

    With a ``mesh`` (one with a ``data`` axis, e.g. :func:`~async_ev_cnn_torch.
    parallel.make_mesh`) the step is data-parallel over ``data``: each rank
    takes its slice of the (global, the same on every rank) batch, the
    mean loss of its slice, and the gradients averaged over the ranks by
    one all_reduce of a flat bucket before Adam, so the parameters and
    Adam's state stay the same on every rank; the loss returned is the
    global mean.  A batch that ``data`` does not divide raises."""

    def __init__(
        self,
        net: EventNetwork,
        num_classes: int,
        num_bbox: int,
        grid_shape: tuple[int, int],
        learning_rate: float = 1e-3,
        mesh=None,
    ):
        self._data = None
        if mesh is not None:
            from async_ev_cnn_torch.parallel.mesh import Comm, mesh_device

            if "data" not in (mesh.mesh_dim_names or ()):
                raise ValueError(
                    f"a training mesh needs a 'data' axis, got {mesh.mesh_dim_names}")
            self._data = Comm(mesh.get_group("data"), mesh_device(mesh))
        self.net = net
        self.num_classes = num_classes
        self.num_bbox = num_bbox
        self.grid_shape = grid_shape
        self.learning_rate = learning_rate

    def init(self, params: dict) -> torch.optim.Adam:
        """Adam over ``params`` in sorted key order (its count at 0); the
        tensors are set to require grad in place."""
        for key in sorted(params):
            if not params[key].is_leaf:
                raise ValueError(f"parameter {key!r} is not a leaf tensor")
            params[key].requires_grad_(True)
        return torch.optim.Adam([params[k] for k in sorted(params)], lr=self.learning_rate,
                                betas=ADAM_BETAS, eps=ADAM_EPS)

    def _forward_grid(self, params, frames: torch.Tensor) -> torch.Tensor:
        """Frames ``[N, H, W]`` -> grids ``[N, S_h, S_w, C + B*5]``: one
        dense forward over the batch, then the dense tail."""
        outs = dense_forward(self.net.event_layers, params, frames[:, None], "tf")
        last = next(reversed(outs.values()))
        out = self.net.apply_tail(params, last.permute(0, 2, 3, 1))
        sh, sw = self.grid_shape
        return out.reshape(frames.shape[0], sh, sw, self.num_classes + self.num_bbox * 5)

    def _batch_loss(self, params, frames: torch.Tensor, targets: YoloTargets) -> torch.Tensor:
        """The mean of the examples' losses."""
        grids = self._forward_grid(params, frames)
        return yolo_loss(grids, targets, self.num_classes, self.num_bbox).mean()

    def step(self, params, opt_state: torch.optim.Adam, frames: torch.Tensor,
             targets: YoloTargets):
        """One Adam step on a batch of integrated frames ``[N, H, W]`` and
        :class:`YoloTargets` with a leading batch axis; the loss is the
        batch's before the step."""
        data = self._data
        if data is not None:
            n = frames.shape[0]
            if n % data.size:
                raise ValueError(
                    f"batch of {n} not divisible by the mesh's data axis ({data.size})")
            rows = slice(data.rank * n // data.size, (data.rank + 1) * n // data.size)
            frames = frames[rows]
            targets = YoloTargets(*(t[rows] for t in targets))
        with _step_flags(frames.device):
            opt_state.zero_grad(set_to_none=True)
            loss = self._batch_loss(params, frames, targets)
            loss.backward()
            if data is not None:
                grads = [params[k].grad for k in sorted(params)]
                flat = data.sum(torch.cat([g.reshape(-1) for g in grads])) / data.size
                for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                    g.copy_(part.view_as(g))
                loss = data.sum(loss.detach()) / data.size
            opt_state.step()
        return params, opt_state, loss.detach()


def _adam_leaves(params: dict, opt: torch.optim.Adam) -> tuple:
    """``(count, mu, nu)`` of ``opt`` over ``params``: count an int, the
    moments dicts of the port's tensors (zeros before the first step)."""
    count, mu, nu = 0, {}, {}
    for key, p in params.items():
        st = opt.state.get(p)
        if st:
            count = int(st["step"])
            mu[key], nu[key] = st["exp_avg"], st["exp_avg_sq"]
        else:
            mu[key], nu[key] = torch.zeros_like(p), torch.zeros_like(p)
    return count, mu, nu


def save_adam_state(path: str, params: dict, opt: torch.optim.Adam) -> None:
    """Write ``opt``'s state as the JAX package writes ``optax.adam``'s:
    the int32 count, then ``mu``, then ``nu`` in the checkpoint layout."""
    count, mu, nu = _adam_leaves(params, opt)
    save_stream_state(path, (np.int32(count), params_to_jax(mu), params_to_jax(nu)))


def restore_adam_state(path: str, params: dict, opt: torch.optim.Adam) -> None:
    """Load an optimizer state written by :func:`save_adam_state` or by
    the JAX training CLI into ``opt`` (over ``params``): shapes and dtypes
    are checked leaf by leaf, moments land on the parameters' devices in
    the port's layout."""
    _, mu, nu = _adam_leaves(params, opt)
    like = (torch.zeros((), dtype=torch.int32),
            {k: torch.from_numpy(a) for k, a in params_to_jax(mu).items()},
            {k: torch.from_numpy(a) for k, a in params_to_jax(nu).items()})
    count, mu, nu = restore_stream_state(path, like)
    device = next(iter(params.values())).device
    mu, nu = params_from_jax(mu, device), params_from_jax(nu, device)
    for key, p in params.items():
        # Adam's own form of the count: a float tensor on the host
        opt.state[p] = {"step": torch.tensor(float(count)), "exp_avg": mu[key],
                        "exp_avg_sq": nu[key]}
