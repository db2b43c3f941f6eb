"""Deterministic floating-point fences for stateful event-driven updates.

Counterpart of ``async_ev_cnn_tpu/ops/numerics.py`` (its docstring gives
the full argument).  Every product that feeds a state accumulation is
rounded to a ``2**-20`` grid:

    snap(x) = round(x * 2**20) * 2**-20

The two scalings are powers of two, hence exact; ``torch.round`` rounds
half to even, like ``jnp.round``, so the port lands on the same grid
point as the JAX package bit for bit.  The CUDA kernels repeat the same
three operations with ``rintf`` (also half to even; ``roundf`` would round
half away from zero) and are compiled with ``--fmad=false``.
"""

from __future__ import annotations

import torch

SNAP_BITS = 20
_UP = 2.0**SNAP_BITS
_DOWN = 2.0**-SNAP_BITS


def snap(x: torch.Tensor) -> torch.Tensor:
    """Round a float32 tensor to the 2**-20 grid (see module docstring)."""
    return torch.round(x * _UP) * _DOWN


def float32_scalar(value, device) -> torch.Tensor:
    """A 0-dim float32 tensor: a Python float (a leak rate) rounds to
    float32 once, as ``jnp.float32(value)`` does, before any product."""
    return torch.tensor(value, dtype=torch.float32, device=device)
