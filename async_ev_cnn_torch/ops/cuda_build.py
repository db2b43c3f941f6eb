"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` is compiled for Hopper (``sm_90a``) into a shared
library with a plain C interface under ``build/kernels/`` at the root of
the checkout, named by a hash of the source and the flags, and loaded with
``ctypes``.  A later process finds the library by the same hash and skips
the build.  Nothing here runs at import: importing the package never needs
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

# --fmad=false: no multiply-add is contracted into an FMA, so the kernels'
# snap fences round where the plain versions do (see csrc/surface_scan.cu).
# -Xptxas=-v writes each kernel's registers, shared memory and spills to
# the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: one lock per source, so two sources build at once from two threads
_BUILD_LOCKS: dict[str, threading.Lock] = {}
#: seconds each library took to build in this process (absent: found built)
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
            "CUDA kernels are built from csrc/ at first use")
    return found


def library_path(name: str) -> Path:
    """Where the built library of ``csrc/<name>.cu`` lives."""
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{key}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    Safe to call from several threads: each source builds once, and two
    sources build in parallel."""
    with _LOCK:
        build_lock = _BUILD_LOCKS.setdefault(name, threading.Lock())
    with build_lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        out = library_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed to build csrc/{name}.cu "
                    f"(exit {proc.returncode}):\n{proc.stderr}")
            out.with_suffix(".log").write_text(proc.stderr)
            os.replace(tmp, out)  # atomic: a reader never sees a partial file
            BUILD_SECONDS[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
        return lib


def build_log(name: str) -> str:
    """nvcc's output (with ``-Xptxas=-v``) from building ``csrc/<name>.cu``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_all(names) -> None:
    """Build and load several sources at once: one ``nvcc`` per source, all
    started together."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        for future in [pool.submit(load, n) for n in names]:
            future.result()


# ---- the wrappers' launch discipline ---------------------------------------


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (the wrapper then runs its
    plain version), False when all lie on the card; raises on a mix."""
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"tensors must all lie on the CPU or all on the card, "
                     f"got {sorted(devices)}")


def weights_cache(cache: dict, key, make, *tensors):
    """``make(*tensors)``, kept in ``cache`` under ``key`` and made anew
    when one of ``tensors`` is another tensor, or its version or storage
    has moved (a write in place, ``.data`` rebound).  An inference tensor
    keeps no version, so its entry is made at every call.  A kernel's
    wrapper keeps its weights in the form the kernel takes this way, once
    per weight tensor."""
    stamp = tuple((None if t.is_inference() else t._version, t.data_ptr()) for t in tensors)
    hit = cache.get(key)
    if (hit is None or len(hit[0]) != len(tensors)
            or any(a is not b for a, b in zip(hit[0], tensors)) or hit[1] != stamp
            or any(v is None for v, _ in stamp)):
        hit = cache[key] = (tensors, stamp, make(*tensors))
    return hit[2]


def check(name, tensor, dtype, device, ndim) -> None:
    """Raise unless ``tensor`` is what a kernel takes: its device, dtype,
    rank, and contiguous."""
    if tensor.device != device:
        raise ValueError(f"{name} is on {tensor.device}, expected {device}")
    if tensor.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {tensor.dtype}")
    if tensor.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(tensor.shape)}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(tensor.data_ptr())


def launch(lib_name: str, fn_name: str, device, *args) -> None:
    """Call the C entry ``fn_name`` of ``csrc/<lib_name>.cu`` on ``device``'s
    current stream (appended as the last argument); raise if the launch
    failed.  Every argument is already a ``ctypes`` value."""
    import torch

    fn = getattr(load(lib_name), fn_name)
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {err}")
