"""Checkpoint-convention weights to the port's parameter tensors, and back,
and darknet's batch norm folded into the convs at load."""

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


#: darknet's batch-norm epsilon, added to the standard deviation
DARKNET_BN_EPS = 1e-6
_BN = ("gamma_", "beta_", "mean_", "var_")


def fold_batchnorm(params: dict, eps: float = DARKNET_BN_EPS, form: str = "darknet") -> dict:
    """Darknet's batch norm, ``(x - mean) / (sqrt(var) + eps) * gamma +
    beta`` after a conv without bias, folded into the conv: for each conv
    ``<name>`` with ``gamma_<name>``, ``beta_<name>``, ``mean_<name>`` and
    ``var_<name>`` (``[O]`` each), ``w_<name>`` (OIHW, the port's layout)
    is scaled over its output channels by ``s = gamma / (sqrt(var) + eps)``
    and ``b_<name>`` becomes ``beta - mean * s``.  ``form='torch'`` folds
    PyTorch's ``BatchNorm2d`` (YOLOX's) instead, ``s = gamma / sqrt(var +
    eps)``.  The statistics leave the dict; every other entry passes
    unchanged, so a dict without them comes back as it is.  Folding rounds
    differently from the unfolded form, by a few float32 ulps."""
    if form not in ("darknet", "torch"):
        raise ValueError(f"form must be 'darknet' or 'torch', got {form!r}")
    out = {k: v for k, v in params.items() if not k.startswith(_BN)}
    for key in params:
        if not key.startswith("gamma_"):
            continue
        name = key[len("gamma_"):]
        var = params[f"var_{name}"]
        scale = params[key] / (var.sqrt() + eps if form == "darknet" else (var + eps).sqrt())
        w = params[f"w_{name}"]
        out[f"w_{name}"] = w * scale.reshape(-1, *([1] * (w.dim() - 1)))
        out[f"b_{name}"] = params[f"beta_{name}"] - params[f"mean_{name}"] * scale
    return out
