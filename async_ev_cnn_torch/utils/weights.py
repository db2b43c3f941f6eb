"""Checkpoint-convention weights to the port's parameter tensors."""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(params: dict, device) -> dict:
    """The JAX package's parameter dict as the port's tensors on ``device``.

    Conv kernels ``w_<name>`` are HWIO in the checkpoint convention and
    OIHW in the port (the transpose the JAX package applies per call);
    biases ``b_<name>`` and the 2-D fc weights pass unchanged.
    """
    out = {}
    for key, value in params.items():
        a = np.asarray(value)
        if key.startswith("w_") and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        out[key] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out
