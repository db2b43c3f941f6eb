"""Pure-Python reader and writer for TensorFlow TensorBundle checkpoints (v2).

Copied from ``async_ev_cnn_tpu/utils/tf_bundle.py`` (host code, framework
free; tests/test_torch_checkpoint.py holds the copy against the original,
byte for byte on the files it writes).  It lets TF-trained eFCN weights
(``w_conv1``/``b_conv1``…) load without TensorFlow.

A v2 checkpoint is a pair of files:

* ``<prefix>.index`` — an LevelDB-style SSTable mapping variable names to
  serialized ``BundleEntryProto`` messages (dtype, shape, shard, offset,
  size).  The empty key holds the ``BundleHeaderProto``.
* ``<prefix>.data-NNNNN-of-MMMMM`` — concatenated raw little-endian tensor
  bytes, addressed by the (offset, size) from the index.

Only the features TensorBundle actually emits are implemented: uncompressed
or snappy-compressed blocks (snappy decoding is implemented inline — the
format is a simple LZ77 variant), single- and multi-shard data files, and
the numeric dtypes.  Variable-length string tensors and slices are not
supported (the eFCN checkpoints contain none).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, Tuple

import numpy as np

_TABLE_MAGIC = 0xDB4775248B80FB57

# TF DataType enum -> numpy dtype (tensorflow/core/framework/types.proto)
_DTYPES = {
    1: np.float32,
    2: np.float64,
    3: np.int32,
    4: np.uint8,
    5: np.int16,
    6: np.int8,
    8: np.complex64,
    9: np.int64,
    10: np.bool_,
    14: None,  # bfloat16 — handled specially below
    17: np.uint16,
    18: np.complex128,
    19: np.float16,
    22: np.uint32,
    23: np.uint64,
}


# ---------------------------------------------------------------------------
# varint / proto-lite decoding
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _proto_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) from a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_shape(buf: bytes) -> Tuple[int, ...]:
    """TensorShapeProto: repeated Dim dim = 2; Dim.size = field 1 (varint,
    zig-zag NOT used — plain int64)."""
    dims = []
    for field, _, val in _proto_fields(buf):
        if field == 2:  # Dim submessage
            for f2, _, v2 in _proto_fields(val):
                if f2 == 1:
                    # int64 varint; negative sizes (unknown) won't appear here
                    dims.append(v2 if v2 < (1 << 63) else v2 - (1 << 64))
    return tuple(dims)


class BundleEntry:
    __slots__ = ("dtype_enum", "shape", "shard_id", "offset", "size",
                 "crc32c")

    def __init__(self):
        self.dtype_enum = 0
        self.shape: Tuple[int, ...] = ()
        self.shard_id = 0
        self.offset = 0
        self.size = 0
        self.crc32c = None  # masked crc32c of the tensor bytes (field 6)


def _parse_entry(buf: bytes) -> BundleEntry:
    e = BundleEntry()
    for field, _, val in _proto_fields(buf):
        if field == 1:
            e.dtype_enum = val
        elif field == 2:
            e.shape = _parse_shape(val)
        elif field == 3:
            e.shard_id = val
        elif field == 4:
            e.offset = val
        elif field == 5:
            e.size = val
        elif field == 6:
            e.crc32c = val
    return e


# ---------------------------------------------------------------------------
# snappy block decompression (raw format, stdlib-free)
# ---------------------------------------------------------------------------


def _snappy_decompress(data: bytes) -> bytes:
    total, pos = _read_varint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = (tag >> 2) + 1
            if ln > 60:
                extra = ln - 60
                ln = int.from_bytes(data[pos : pos + extra], "little") + 1
                pos += extra
            out += data[pos : pos + ln]
            pos += ln
        else:
            if kind == 1:  # copy, 1-byte offset
                ln = ((tag >> 2) & 7) + 4
                off = ((tag >> 5) << 8) | data[pos]
                pos += 1
            elif kind == 2:  # copy, 2-byte offset
                ln = (tag >> 2) + 1
                off = int.from_bytes(data[pos : pos + 2], "little")
                pos += 2
            else:  # copy, 4-byte offset
                ln = (tag >> 2) + 1
                off = int.from_bytes(data[pos : pos + 4], "little")
                pos += 4
            start = len(out) - off
            if start < 0:
                raise ValueError("corrupt snappy stream")
            for i in range(ln):  # may overlap — byte-by-byte is required
                out.append(out[start + i])
    if len(out) != total:
        raise ValueError("snappy length mismatch")
    return bytes(out)


# ---------------------------------------------------------------------------
# LevelDB-style SSTable reading
# ---------------------------------------------------------------------------


def _read_block(data: bytes, offset: int, size: int) -> bytes:
    """Read a table block given its handle; verify the 5-byte trailer
    (compression type byte + masked crc32c of block+type) and strip it."""
    raw = data[offset : offset + size]
    ctype = data[offset + size]  # 1-byte compression type in the trailer
    want = struct.unpack_from("<I", data, offset + size + 1)[0]
    if _masked_crc(raw + bytes([ctype])) != want:
        raise ValueError(
            "index block checksum mismatch (corrupt or truncated "
            "checkpoint index)"
        )
    if ctype == 0:
        return raw
    if ctype == 1:
        return _snappy_decompress(raw)
    raise ValueError(f"unsupported block compression {ctype}")


def _block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """Iterate (key, value) pairs of one block (prefix-compressed keys)."""
    num_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    data_end = len(block) - 4 - 4 * num_restarts
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _read_varint(block, pos)
        non_shared, pos = _read_varint(block, pos)
        value_len, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos : pos + non_shared]
        pos += non_shared
        value = block[pos : pos + value_len]
        pos += value_len
        yield key, value


def _decode_handle(buf: bytes, pos: int = 0) -> Tuple[int, int, int]:
    offset, pos = _read_varint(buf, pos)
    size, pos = _read_varint(buf, pos)
    return offset, size, pos


def read_sstable(path: str) -> Dict[bytes, bytes]:
    """Read every (key, value) pair of an SSTable file."""
    with open(path, "rb") as f:
        data = f.read()
    footer = data[-48:]
    magic = struct.unpack_from("<Q", footer, 40)[0]
    if magic != _TABLE_MAGIC:
        raise ValueError(f"{path}: not an SSTable (bad magic)")
    _, _, pos = _decode_handle(footer, 0)  # metaindex handle (unused)
    idx_off, idx_size, _ = _decode_handle(footer, pos)
    index_block = _read_block(data, idx_off, idx_size)
    out: Dict[bytes, bytes] = {}
    for _, handle in _block_entries(index_block):
        boff, bsize, _ = _decode_handle(handle)
        for key, value in _block_entries(_read_block(data, boff, bsize)):
            out[key] = value
    return out


# ---------------------------------------------------------------------------
# writing (single-shard, uncompressed)
# ---------------------------------------------------------------------------


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _encode_handle(offset: int, size: int) -> bytes:
    out = bytearray()
    _write_varint(out, offset)
    _write_varint(out, size)
    return bytes(out)


def _crc_tables():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        t0 = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
            t0.append(crc)
        _CRC_TABLE = [t0]
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli).  The native SSE4.2 path (``native/evio.cc``,
    built at first use by :mod:`async_ev_cnn_torch.data.native`) when the
    library is available, as in the JAX package; else the table loop,
    which gives the same checksum at ~6 MB/s."""
    from async_ev_cnn_torch.data.native import crc32c as _native_crc

    native = _native_crc(data)
    if native is not None:
        return native
    t0 = _crc_tables()[0]
    crc = 0xFFFFFFFF
    for b in data:
        crc = t0[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


_CRC_TABLE = None


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    rotated = ((crc >> 15) | (crc << 17)) % (1 << 32)
    return (rotated + 0xA282EAD8) % (1 << 32)


def _write_block(entries) -> bytes:
    """One uncompressed table block holding (key, value) pairs, restart
    interval 16 (LevelDB default); returns block bytes incl. trailer."""
    out = bytearray()
    restarts = []
    prev_key = b""
    for n, (key, value) in enumerate(entries):
        if n % 16 == 0:
            restarts.append(len(out))
            shared = 0
        else:
            shared = 0
            while (shared < len(prev_key) and shared < len(key)
                   and prev_key[shared] == key[shared]):
                shared += 1
        _write_varint(out, shared)
        _write_varint(out, len(key) - shared)
        _write_varint(out, len(value))
        out += key[shared:]
        out += value
        prev_key = key
    if not restarts:
        restarts = [0]
    for r in restarts:
        out += struct.pack("<I", r)
    out += struct.pack("<I", len(restarts))
    block = bytes(out)
    trailer = bytes([0]) + struct.pack("<I", _masked_crc(block + b"\x00"))
    return block + trailer


def _proto_field(field: int, wire: int, payload) -> bytes:
    out = bytearray()
    _write_varint(out, (field << 3) | wire)
    if wire == 0:
        _write_varint(out, payload)
    elif wire == 2:
        _write_varint(out, len(payload))
        out += payload
    elif wire == 5:
        out += struct.pack("<I", payload)
    else:
        raise ValueError(wire)
    return bytes(out)


_NP_TO_DTYPE = {
    np.dtype(np.float32): 1, np.dtype(np.float64): 2, np.dtype(np.int32): 3,
    np.dtype(np.uint8): 4, np.dtype(np.int16): 5, np.dtype(np.int8): 6,
    np.dtype(np.int64): 9, np.dtype(np.bool_): 10, np.dtype(np.uint16): 17,
    np.dtype(np.float16): 19, np.dtype(np.uint32): 22, np.dtype(np.uint64): 23,
}


def save_tensor_bundle(prefix: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write a TF v2 checkpoint (single shard) readable by TensorFlow and by
    :func:`load_tensor_bundle` — the write direction of the reference's
    checkpoint interop."""
    import os

    names = sorted(tensors)
    data_path = _shard_path(prefix, 0, 1)
    offset = 0
    entries = []
    # write-to-temp + os.replace per file, marker last: overwriting the
    # live .data before the .index left a crash window where OLD index
    # offsets pointed into NEW data and garbage bytes loaded as weights
    with open(data_path + ".tmp", "wb") as f:
        for name in names:
            arr = np.ascontiguousarray(tensors[name])
            if arr.dtype not in _NP_TO_DTYPE:
                raise NotImplementedError(f"dtype {arr.dtype} for {name!r}")
            raw = arr.tobytes()
            f.write(raw)
            shape_proto = b"".join(
                _proto_field(2, 2, _proto_field(1, 0, int(d))) for d in arr.shape
            )
            entry = (
                _proto_field(1, 0, _NP_TO_DTYPE[arr.dtype])
                + (_proto_field(2, 2, shape_proto))
                + _proto_field(4, 0, offset)
                + _proto_field(5, 0, len(raw))
                + _proto_field(6, 5, _masked_crc(raw))  # fixed32 crc32c
            )
            entries.append((name.encode(), entry))
            offset += len(raw)

    # BundleHeaderProto under the empty key: num_shards=1, LITTLE endian(=0)
    header = _proto_field(1, 0, 1)
    index_entries = [(b"", header)] + entries

    data_block = _write_block(index_entries)
    meta_block = _write_block([])  # empty metaindex
    out = bytearray()
    out += data_block
    data_handle = _encode_handle(0, len(data_block) - 5)
    meta_off = len(out)
    out += meta_block
    meta_handle = _encode_handle(meta_off, len(meta_block) - 5)
    # index block: one entry whose key sorts >= the last data key
    index_block = _write_block([(index_entries[-1][0] + b"\xff", data_handle)])
    idx_off = len(out)
    out += index_block
    idx_handle = _encode_handle(idx_off, len(index_block) - 5)
    footer = bytearray()
    footer += meta_handle
    footer += idx_handle
    footer += b"\x00" * (40 - len(footer))
    footer += struct.pack("<Q", _TABLE_MAGIC)
    out += footer
    with open(prefix + ".index.tmp", "wb") as f:
        f.write(bytes(out))
    os.replace(data_path + ".tmp", data_path)
    os.replace(prefix + ".index.tmp", prefix + ".index")
    # the 'checkpoint' CheckpointState text proto: tf.train.latest_checkpoint
    # resolves DIRECTORIES through it — without the marker, reference users
    # pointing at the export dir get None and crash (event_numpy.py:37-40)
    base = os.path.basename(prefix)
    marker = os.path.join(os.path.dirname(os.path.abspath(prefix)),
                          "checkpoint")
    with open(marker + ".tmp", "w") as f:
        f.write(f'model_checkpoint_path: "{base}"\n'
                f'all_model_checkpoint_paths: "{base}"\n')
    os.replace(marker + ".tmp", marker)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _shard_path(prefix: str, shard: int, num_shards: int) -> str:
    return f"{prefix}.data-{shard:05d}-of-{num_shards:05d}"


def list_variables(prefix: str) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """Map of variable name -> (shape, dtype enum)."""
    table = read_sstable(prefix + ".index")
    out = {}
    for key, value in table.items():
        if not key:
            continue
        e = _parse_entry(value)
        out[key.decode()] = (e.shape, e.dtype_enum)
    return out


def load_tensor_bundle(prefix: str) -> Dict[str, np.ndarray]:
    """Load every tensor of a TF v2 checkpoint into a numpy dict."""
    table = read_sstable(prefix + ".index")
    # BundleHeaderProto under the empty key: field 1 = num_shards
    num_shards = 1
    header = table.get(b"")
    if header:
        for field, _, val in _proto_fields(header):
            if field == 1:
                num_shards = val
    shard_data: Dict[int, bytes] = {}
    out: Dict[str, np.ndarray] = {}
    for key, value in sorted(table.items()):
        if not key:
            continue
        e = _parse_entry(value)
        if e.shard_id not in shard_data:
            with open(_shard_path(prefix, e.shard_id, num_shards), "rb") as f:
                shard_data[e.shard_id] = f.read()
        raw = shard_data[e.shard_id][e.offset : e.offset + e.size]
        if e.dtype_enum == 7:
            # DT_STRING — TF bookkeeping (e.g. _CHECKPOINTABLE_OBJECT_GRAPH),
            # never model weights; skip (note: its entry crc covers TF's
            # length-prefixed string encoding, not these raw bytes).
            continue
        if e.crc32c is not None and _masked_crc(raw) != e.crc32c:
            # TF's BundleReader raises DataLoss here; silently handing a
            # bit-flipped shard back as model weights is worse
            raise ValueError(
                f"tensor {key.decode()!r}: data shard checksum mismatch "
                "(corrupt or truncated checkpoint)"
            )
        if e.dtype_enum == 14:  # bfloat16: upcast via uint16 -> float32 bits
            u = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
            arr = u.view(np.float32)
        else:
            np_dtype = _DTYPES.get(e.dtype_enum)
            if np_dtype is None:
                raise NotImplementedError(
                    f"dtype enum {e.dtype_enum} for variable {key.decode()!r}"
                )
            arr = np.frombuffer(raw, np_dtype)
        out[key.decode()] = arr.reshape(e.shape).copy()
    return out
