"""ctypes bindings for the native event decoder, built from ``native/evio.cc``.

Counterpart of ``async_ev_cnn_tpu/data/native.py``: the same entry points,
each giving what the numpy codecs of ``file_reader.py`` give bit for bit,
or ``None`` when the library is unavailable (the readers then take the
numpy codecs: host decoding either way, the device path is the same).

Where the JAX package loads a library built by hand (``make -C native``
writes ``native/libevio.so``, its loader's path), the port builds the same
source at first use with the host's C++ compiler (``g++``, or ``$CXX``;
no CUDA compiler) into ``build/native/`` at the root of the checkout,
named by a hash of the source and the flags, and never into ``native/``.
The flags are the Makefile's less ``-march=native``, so a library built on
one host runs on another (``-msse4.2`` on x86-64 keeps the CRC-32C's
hardware path).  A compiler without OpenMP (no ``libgomp``) builds it
without ``-fopenmp``: the source guards its OpenMP use, and the batch
decode then runs its files one after another, with the same results.  No
compiler, or a build that fails (with a warning), means no library;
``ASYNC_EV_NATIVE=0`` turns the library off.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent.parent / "native" / "evio.cc"
BUILD_DIR = SOURCE.parent.parent / "build" / "native"
CXXFLAGS = ("-O3", "-fPIC", "-Wall", "-Wextra", "-shared") + (
    ("-msse4.2",) if platform.machine() in ("x86_64", "AMD64") else ())
OPENMP = ("-fopenmp",)

_LIB = None
_TRIED = False
_LOCK = threading.Lock()


def compiler() -> str | None:
    """The host C++ compiler: ``$CXX``, else ``g++`` on the PATH."""
    return shutil.which(os.environ.get("CXX", "g++"))


def library_path(build_dir=None, openmp: bool = True) -> Path:
    """Where the library built from the current source and flags (with or
    without OpenMP: ``libevio_omp_*`` or ``libevio_*``) lives."""
    flags = CXXFLAGS + (OPENMP if openmp else ())
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return Path(build_dir or BUILD_DIR) / f"libevio_{'omp_' if openmp else ''}{key}.so"


def build(build_dir=None) -> Path:
    """Build ``native/evio.cc`` into ``build_dir`` (``build/native/`` when
    not given) unless a library of this source and these flags is there
    already; returns its path.  With OpenMP where the compiler has it, else
    without.  The library is written under a temporary name and renamed,
    so a process that finds it finds it whole.  Raises ``RuntimeError``
    without a compiler or when neither build succeeds."""
    for openmp in (True, False):
        if library_path(build_dir, openmp).exists():
            return library_path(build_dir, openmp)
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (set CXX or put g++ on the PATH)")
    errors = []
    for openmp in (True, False):
        out = library_path(build_dir, openmp)
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        flags = CXXFLAGS + (OPENMP if openmp else ())
        proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode == 0:
            os.replace(tmp, out)
            return out
        tmp.unlink(missing_ok=True)
        errors.append(f"{' '.join(flags)} (exit {proc.returncode}):\n{proc.stderr}")
    raise RuntimeError(f"{cxx} failed to build {SOURCE.name}: " + "; ".join(errors))


def load(path) -> ctypes.CDLL:
    """Load the library at ``path`` and declare its entry points."""
    lib = ctypes.CDLL(str(path))
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    def cfg(name, restype, argtypes):
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes

    cfg("evio_decode_ndata", ctypes.c_int64, [u8p, ctypes.c_int64] + [i32p] * 4)
    cfg("evio_decode_ndata_batch_cap", None,
        [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
         ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        + [i32p] * 4 + [ctypes.POINTER(ctypes.c_int64)])
    cfg("evio_decode_aedat31", ctypes.c_int64,
        [u8p, ctypes.c_int64, i32p, i32p,
         ctypes.POINTER(ctypes.c_int64), i32p])
    cfg("evio_decode_aedat20", ctypes.c_int64,
        [u8p, ctypes.c_int64] + [i32p] * 4)
    cfg("evio_decode_evt3", ctypes.c_int64,
        [u8p, ctypes.c_int64, ctypes.c_int64] + [i32p] * 4)
    cfg("evio_crc32c", ctypes.c_uint32, [ctypes.c_char_p, ctypes.c_int64])
    return lib


def get_lib():
    """The library, built at the first call of the process; None when
    ``ASYNC_EV_NATIVE=0``, without a compiler or when the build fails."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("ASYNC_EV_NATIVE", "1") == "0" or compiler() is None:
            return None
        try:
            _LIB = load(build())
        except (RuntimeError, OSError) as e:
            warnings.warn(f"native event decoder unavailable, using the numpy codecs: {e}")
        return _LIB


def available() -> bool:
    return get_lib() is not None


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def decode_ndata_file(path: str):
    """Native n-data decode; returns ``(length, x, y, ts, p)`` or None if the
    library is unavailable.

    Reads the bytes in Python and decodes the BUFFER: sizing the output
    arrays from os.path.getsize while the C side re-read the (possibly
    grown) file was a TOCTOU buffer overrun."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.fromfile(path, np.uint8)
    cap = buf.size // 5
    x = np.empty(cap, np.int32)
    y = np.empty(cap, np.int32)
    ts = np.empty(cap, np.int32)
    p = np.empty(cap, np.int32)
    n = lib.evio_decode_ndata(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
        _i32p(x), _i32p(y), _i32p(ts), _i32p(p))
    if n < 0:
        raise IOError(f"native decode failed for {path}")
    return int(n), x[:n], y[:n], ts[:n], p[:n]


def decode_aedat20(payload: np.ndarray):
    """Native AEDAT 2.0 payload decode (DVS128 masks); None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    payload = np.ascontiguousarray(payload, np.uint8)
    cap = payload.size // 8
    x = np.empty(cap, np.int32)
    y = np.empty(cap, np.int32)
    ts = np.empty(cap, np.int32)
    p = np.empty(cap, np.int32)
    n = int(lib.evio_decode_aedat20(
        payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), payload.size,
        _i32p(x), _i32p(y), _i32p(ts), _i32p(p),
    ))
    return n, x[:n], y[:n], ts[:n], p[:n]


def decode_aedat31(payload: np.ndarray):
    """Native AEDAT 3.1 packet-walk decode of a header-stripped payload.

    Returns ``(length, x, y, ts[int64], p)`` or None if unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    payload = np.ascontiguousarray(payload, np.uint8)
    cap = payload.size // 8
    x = np.empty(cap, np.int32)
    y = np.empty(cap, np.int32)
    ts = np.empty(cap, np.int64)
    p = np.empty(cap, np.int32)
    n = lib.evio_decode_aedat31(
        payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), payload.size,
        _i32p(x), _i32p(y), ts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _i32p(p),
    )
    n = int(n)
    return n, x[:n], y[:n], ts[:n], p[:n]


def decode_ndata_batch(paths: list[str]):
    """OpenMP-parallel batched decode of many n-data files.

    Returns a list of ``(length, x, y, ts, p)`` tuples.
    """
    lib = get_lib()
    if lib is None:
        return None
    caps = np.array([os.path.getsize(p) // 5 for p in paths], np.int64)
    offsets = np.zeros(len(paths), np.int64)
    np.cumsum(caps[:-1], out=offsets[1:])
    total = int(caps.sum())
    x = np.empty(total, np.int32)
    y = np.empty(total, np.int32)
    ts = np.empty(total, np.int32)
    p = np.empty(total, np.int32)
    lengths = np.empty(len(paths), np.int64)
    c_paths = (ctypes.c_char_p * len(paths))(*[s.encode() for s in paths])
    # the C side clamps each file to caps[i] records: without the clamp a
    # file that GREW between getsize and the decoder's own read overran
    # the output buffers (heap corruption)
    lib.evio_decode_ndata_batch_cap(
        c_paths, len(paths), offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        caps.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _i32p(x), _i32p(y), _i32p(ts), _i32p(p),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    out = []
    for i, path in enumerate(paths):
        n = int(lengths[i])
        if n < 0:
            raise IOError(f"native decode failed for {path}")
        o = int(offsets[i])
        out.append((n, x[o : o + n].copy(), y[o : o + n].copy(),
                    ts[o : o + n].copy(), p[o : o + n].copy()))
    return out


def decode_evt3(payload: bytes):
    """Native EVT3 payload decode (header-stripped); None if unavailable.

    The exact output capacity is counted with one cheap vectorized pass
    (ADDR_X words + set validity bits of VECT_12/VECT_8 words) so the
    C++ loop writes into exactly-sized arrays.
    """
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(payload[: len(payload) & ~1], dtype="<u2")
    typ = buf >> 12
    val = (buf & 0xFFF).astype(np.uint32)
    # same int32-µs bound the numpy fallback enforces (evt.py): the
    # C++ loop's int32 ts can wrap all the way past negative for very
    # long recordings, so a min()<0 post-check alone is not equivalent
    th_seq = val[typ == 0x8].astype(np.int64)
    if th_seq.size:
        wraps = np.zeros(th_seq.size, np.int64)
        wraps[1:] = th_seq[1:] < th_seq[:-1]
        th_max = int((th_seq + (np.cumsum(wraps) << 12)).max())
        if th_max > (2**31 - 1) >> 12:
            raise ValueError(
                "EVT3 unwrapped timestamps exceed the int32 µs range "
                f"(TIME_HIGH reaches {th_max} > {(2**31 - 1) >> 12}); "
                "rebase or split the recording before decoding"
            )
    bits12 = val[typ == 0x4]
    bits8 = val[typ == 0x5] & 0xFF
    popcount = np.unpackbits(
        np.concatenate([bits12, bits8]).astype(">u2").view(np.uint8)
    ).sum() if (bits12.size or bits8.size) else 0
    cap = int((typ == 0x2).sum()) + int(popcount)
    x = np.empty(cap, np.int32)
    y = np.empty(cap, np.int32)
    ts = np.empty(cap, np.int32)
    p = np.empty(cap, np.int32)
    arr = np.ascontiguousarray(buf).view(np.uint8)
    n = int(lib.evio_decode_evt3(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size,
        cap, _i32p(x), _i32p(y), _i32p(ts), _i32p(p),
    ))
    if n < 0 or n != cap:
        # the prepass count and the C++ loop must agree exactly; any
        # mismatch means the two counting implementations diverged
        raise IOError(
            f"native EVT3 decode count mismatch: prepass {cap}, loop {n}"
        )
    if n and int(ts.min()) < 0:
        # wire times are non-negative, so a negative decoded µs value can
        # only be int32 wrap of a >2^31 µs (~35.8 min) recording — the
        # same condition the numpy fallback raises on explicitly
        raise ValueError(
            "EVT3 timestamps exceed the int32 µs range (decoded values "
            "wrapped negative); rebase or split the recording"
        )
    return n, x, y, ts, p


def crc32c(data: bytes):
    """CRC-32C via the native library (SSE4.2 crc32 instruction), or
    ``None`` when the library is unavailable — callers fall back to the
    Python table loop (utils/tf_bundle.py)."""
    lib = get_lib()
    if lib is None:
        return None
    return int(lib.evio_crc32c(data, len(data)))
