"""Checkpoint-convention weights to the port's parameter tensors, and back."""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(params: dict, device) -> dict:
    """The JAX package's parameter dict as the port's tensors on ``device``.

    Conv kernels ``w_<name>`` are HWIO in the checkpoint convention and
    OIHW in the port (the transpose the JAX package applies per call);
    biases ``b_<name>`` and the 2-D fc weights pass unchanged.  The
    tensors are copies on every device: a trainer updates them in place,
    and the caller's arrays must not change with them.
    """
    out = {}
    for key, value in params.items():
        a = np.asarray(value)
        if key.startswith("w_") and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        out[key] = torch.tensor(np.ascontiguousarray(a), device=device)
    return out


def params_to_jax(params: dict) -> dict:
    """The inverse of :func:`params_from_jax`: the port's tensors (on any
    device) as checkpoint-convention host arrays, conv kernels OIHW ->
    HWIO, everything else unchanged.  The same rule maps any dict keyed
    like the parameters, such as Adam's moments."""
    out = {}
    for key, value in params.items():
        a = value.detach().cpu().numpy()
        if key.startswith("w_") and a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        out[key] = np.ascontiguousarray(a)
    return out
