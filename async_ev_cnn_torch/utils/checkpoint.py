"""Model weights and stream state on disk.

Counterpart of ``async_ev_cnn_tpu/utils/checkpoint.py``, host code copied
from it: the reference's checkpoint contract — variables named
``w_conv1``, ``b_conv1``, … ``w_fcN``/``b_fcN`` with HWIO conv kernels —
read from

* ``.npz`` archives (written by :func:`save_params`, with or without the
  extension), or
* TensorFlow v2 checkpoints (TensorBundle), by the pure-Python reader in
  :mod:`async_ev_cnn_torch.utils.tf_bundle`.

Weights load as numpy arrays in the checkpoint convention;
``utils/weights.params_from_jax`` puts them on a device in the port's
layout.  Orbax directories are the JAX ecosystem's format and are refused.

The stream state (:func:`save_stream_state`) is stored as the JAX package
stores it, one ``leaf_<i>`` array per leaf in ``jax.tree.leaves`` order, so
a state saved by either package restores into the other's structure.  The
same two functions store any tree of tuples, lists and dicts (sorted keys,
an ``OrderedDict``'s in insertion order, as JAX takes them), such as the
trainer's optimizer state (``models/train.py``).
"""

from __future__ import annotations

import os
import tempfile
from collections import OrderedDict
from typing import Dict

import numpy as np
import torch


def _atomic_savez(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Write an ``.npz`` atomically at exactly ``path``: a temp file in the
    same directory, then ``os.replace``, so a crash mid-write never leaves
    a truncated archive as the only copy.  The temp suffix does not end in
    '.npz', so :func:`latest_checkpoint` never picks up a crashed write."""
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(path)), suffix=".tmp"
    )
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def latest_checkpoint(path: str) -> str:
    """Resolve a directory to its newest checkpoint prefix.

    Understands TF's ``checkpoint`` index file when present; otherwise picks
    the newest ``*.npz`` or ``*.index`` (minus suffix) by mtime.
    """
    if not os.path.isdir(path):
        return path
    marker = os.path.join(path, "checkpoint")
    if os.path.exists(marker):
        with open(marker) as f:
            for line in f:
                if line.startswith("model_checkpoint_path"):
                    name = line.split(":", 1)[1].strip().strip('"')
                    return name if os.path.isabs(name) else os.path.join(path, name)
    candidates = []
    for fn in os.listdir(path):
        full = os.path.join(path, fn)
        if fn.endswith(".tmp.npz"):
            continue  # leftover of an older, non-atomic write
        if fn.endswith(".npz"):
            candidates.append((os.path.getmtime(full), full))
        elif fn.endswith(".index"):
            candidates.append((os.path.getmtime(full), full[: -len(".index")]))
    if not candidates:
        raise FileNotFoundError(f"no checkpoints found under {path}")
    return max(candidates)[1]


def _is_orbax(path: str) -> bool:
    return os.path.isdir(path) and (
        os.path.exists(os.path.join(path, "_CHECKPOINT_METADATA"))
        or os.path.exists(os.path.join(path, "_METADATA"))
    )


def _is_npz(path: str) -> bool:
    if path.endswith(".npz"):
        return True
    try:  # extension-free .npz (save_params writes the exact path)
        with open(path, "rb") as f:
            return f.read(4) == b"PK\x03\x04"
    except OSError:
        return False


def load_params(path: str, restrict_vars=None) -> Dict[str, np.ndarray]:
    """Load a weight dict from an .npz file or a TF checkpoint (file
    prefix or directory).  ``restrict_vars`` keeps only the names it holds,
    matching object-graph names (``name/.ATTRIBUTES/VARIABLE_VALUE``) by
    their flat name too."""
    if _is_orbax(path):
        raise NotImplementedError(
            f"{path} is an Orbax checkpoint directory; Orbax is JAX-only. "
            "Export the weights with the JAX package's save_params (.npz) or "
            "save_params_tf (TF bundle) and load that")
    path = latest_checkpoint(path)
    if _is_npz(path):
        with np.load(path) as z:
            params = {k: z[k] for k in z.files}
    else:
        from async_ev_cnn_torch.utils.tf_bundle import load_tensor_bundle

        params = load_tensor_bundle(path)
    if restrict_vars is not None:
        params = {
            k: v for k, v in params.items()
            if k in restrict_vars
            or k.split("/.ATTRIBUTES/")[0] in restrict_vars
        }
    return params


def normalize_names(params: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Map object-graph checkpoint names to flat Saver-style names:
    ``w_conv1/.ATTRIBUTES/VARIABLE_VALUE`` becomes ``w_conv1``; flat names
    pass unchanged (the first of two that normalize alike wins)."""
    out = {}
    for key, value in params.items():
        name = key.split("/.ATTRIBUTES/")[0] if "/.ATTRIBUTES/" in key else key
        out.setdefault(name, value)
    return out


def _checkpoint_arrays(params: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``params`` as host arrays, refusing tensors: the port's tensors hold
    conv kernels OIHW, and written as they are they would load as HWIO
    kernels of the wrong shape (``utils/weights.params_to_jax`` converts)."""
    if any(isinstance(v, torch.Tensor) for v in params.values()):
        raise TypeError(
            "save_params takes checkpoint-convention arrays (HWIO kernels); "
            "convert the port's tensors with utils.weights.params_to_jax")
    return {k: np.asarray(v) for k, v in params.items()}


def save_params(path: str, params: Dict[str, np.ndarray]) -> None:
    """Save checkpoint-convention weights as .npz (atomically)."""
    _atomic_savez(path, _checkpoint_arrays(params))


def save_params_tf(prefix: str, params: Dict[str, np.ndarray]) -> None:
    """Write checkpoint-convention weights as a TF v2 checkpoint (pure
    Python, readable by TensorFlow and by :func:`load_params`)."""
    from async_ev_cnn_torch.utils.tf_bundle import save_tensor_bundle

    save_tensor_bundle(prefix, _checkpoint_arrays(params))


# ---- stream state ------------------------------------------------------------


def _keys(tree: dict) -> list:
    """A dict's keys in ``jax.tree.leaves`` order: sorted, but an
    ``OrderedDict``'s in insertion order."""
    return list(tree) if isinstance(tree, OrderedDict) else sorted(tree)


def _leaves(tree) -> list:
    """The leaves of a state tree in ``jax.tree.leaves`` order: tuples and
    lists (NamedTuples in field order) element by element, dicts value by
    value in :func:`_keys` order, ``None`` dropped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in _keys(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return [tree]


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        rebuilt = {k: _rebuild(like[k], leaves) for k in _keys(like)}
        return type(like)((k, rebuilt[k]) for k in like)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(sub, leaves) for sub in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(sub, leaves) for sub in like)
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    """A leaf (a tensor, or a host array taken as it is) as the array the
    JAX package writes for it.  numpy has no bfloat16: JAX's
    ``np.asarray`` gives an ml_dtypes array, which ``np.savez`` stores as
    2-byte voids; a bfloat16 tensor is written as the same bytes (its bits
    as a ``V2`` array)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _numpy_dtype(dtype: torch.dtype):
    """The numpy dtype of a torch dtype; None for bfloat16, which numpy
    lacks (so no stored array matches it)."""
    if dtype == torch.bfloat16:
        return None
    return torch.empty((), dtype=dtype).numpy().dtype


def save_stream_state(path: str, state) -> None:
    """Persist an :class:`~async_ev_cnn_torch.layers.network.EventNetwork`
    state (surfaces, timestamps, layer featuremaps) to one ``.npz`` at
    ``path``: ``leaf_<i>`` per leaf, in ``jax.tree.leaves`` order, as the
    JAX package writes it."""
    _atomic_savez(path, {f"leaf_{i}": _to_numpy(l) for i, l in enumerate(_leaves(state))})


def restore_stream_state(path: str, like):
    """Restore a state saved by :func:`save_stream_state` (of either
    package) into the structure of ``like``, a tree of tensors (e.g. ``net.init_state(params)``:
    the structure is not stored, the network defines it), each leaf on
    ``like``'s device.  Shapes and dtypes must match leaf by leaf: the
    round trip is bit for bit, so nothing is cast (an int64 leaf where the
    structure holds int32 is refused, not narrowed).  A bfloat16 leaf is
    refused as the JAX package refuses it: its stored 2-byte voids are not
    bfloat16 to numpy."""
    leaves = _leaves(like)
    with np.load(path) as z:
        arrs = [z[f"leaf_{i}"] for i in range(len(z.files))]
    if len(arrs) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(arrs)} leaves, structure needs {len(leaves)}"
        )
    out = []
    for i, (a, l) in enumerate(zip(arrs, leaves)):
        if tuple(a.shape) != tuple(l.shape):
            raise ValueError(
                f"leaf {i}: checkpoint shape {a.shape} != structure shape "
                f"{tuple(l.shape)}"
            )
        if a.dtype != _numpy_dtype(l.dtype):
            raise ValueError(
                f"leaf {i}: checkpoint dtype {a.dtype} != structure dtype {l.dtype}"
            )
        out.append(torch.from_numpy(a.copy()).to(l.device))
    return _rebuild(like, iter(out))
