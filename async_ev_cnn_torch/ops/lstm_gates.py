"""G1: the gate update of RVT's ConvLSTM, one pass over a time step's gates.

No Pallas kernel stands behind it: the JAX package runs no recurrent
layer.  The hand-written kernel is ``csrc/lstm_gates.cu`` (the source says
what bounds it); its plain version, :func:`lstm_gates_plain`, is the eager
update: the activations in place on the gates, ``c = f * c + i * z`` in
place on the cell, ``h = o * tanh(c)``.

A call runs inside one ``lstm.gates`` span.  The wrapper runs the plain
version for tensors on the CPU and the kernel for tensors on the card, or
raises; it takes no gradient.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from async_ev_cnn_torch.ops import cuda_build
from async_ev_cnn_torch.ops.cuda_build import check as _check
from async_ev_cnn_torch.ops.cuda_build import on_cpu as _on_cpu
from async_ev_cnn_torch.ops.cuda_build import ptr as _ptr
from async_ev_cnn_torch.utils.profiling import span

#: kernel launches since the counts were last reset
LAUNCHES = {"lstm_gates": 0}


def lstm_gates_plain(g: torch.Tensor, c: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`lstm_gates` (``g`` is overwritten
    with the activated gates)."""
    ch = c.shape[-1]
    g[:, :3 * ch].sigmoid_()
    g[:, 3 * ch:].tanh_()
    f, i, o, z = g.split(ch, dim=1)
    c.mul_(f).addcmul_(i, z)
    return torch.mul(o, torch.tanh(c), out=h)


def lstm_gates(g: torch.Tensor, c: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One step's update: ``g`` f32 ``[R, 4C]`` (the forget, input and output
    gates' and the cell input's pre-activations, RVT's split), ``c`` f32
    ``[R, C]`` (updated in place: ``c = sigmoid(f) * c + sigmoid(i) *
    tanh(z)``), ``h`` f32 ``[R, C]`` (written: ``sigmoid(o) * tanh(c)``);
    returns ``h``."""
    r, ch = c.shape
    if g.shape != (r, 4 * ch) or h.shape != (r, ch):
        raise ValueError(f"the gate update takes g [R, 4C], c and h [R, C], got "
                         f"{tuple(g.shape)}, {tuple(c.shape)} and {tuple(h.shape)}")
    with span("lstm.gates"):
        if _on_cpu(g, c, h):
            return lstm_gates_plain(g, c, h)
        for name, t in (("g", g), ("c", c), ("h", h)):
            _check(name, t, torch.float32, g.device, 2)
        if ch % 4:
            raise ValueError(f"the gate kernel takes a multiple of 4 channels, got {ch}")
        cuda_build.launch("lstm_gates", "lstm_gates", g.device, _ptr(g), _ptr(c), _ptr(h),
                          ctypes.c_longlong(r), ctypes.c_int(ch))
        LAUNCHES["lstm_gates"] += 1
        return h
