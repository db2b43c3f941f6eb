"""Event-file format codecs: N-MNIST/N-Caltech101 binary, AEDAT 2.0/3.1, npy.

Copied from ``async_ev_cnn_tpu/data/file_reader.py`` (host numpy, framework-free),
so the port reads the same files into the same arrays.

Bit-level behavioral parity with the reference's src/readers/file_reader.py
so datasets and files written by either implementation interoperate:

* N-data (file_reader.py:24-74): 5 bytes/event — ``x=b0``, ``y=b1``,
  ``p=bit7(b2)``, ``ts=23 bits of b2..b4``; rows with ``y==240`` are
  timestamp-overflow markers adding 2^13 us to all later events and are
  filtered out.  The writer packs the same 40-bit records (the reference
  needed the ``bitstring`` package; here it's three numpy shifts).
* AEDAT (file_reader.py:77-279): ``#!AER-DAT`` header sniffing; 2.0 =
  big-endian int32 (address, timestamp) pairs with camera-specific masks
  (DVS128); 3.1 = packet stream of 7-int32 headers + polarity events with
  validity-bit filtering and 31-bit timestamp-overflow words.
* npy (file_reader.py:282-299): ``[N, 4]`` arrays of (x, y, ts, p).

Everything is vectorized numpy — no per-event Python loops (the AEDAT 3.1
packet walk iterates packets, not events).  A C++ decoder with the same
output contract lives in ``native/`` for host-side throughput.
"""

from __future__ import annotations

import time

import numpy as np

N_DATA_OVERFLOW_Y = 240
N_DATA_OVERFLOW_INCREMENT = 2**13


class FileReader:
    """Format codec interface: ``read_example(path)`` ->
    ``(length, x, y, ts, p)``; ``save_example(path, x, y, ts, p, version)``."""

    def read_example(self, filename):
        raise NotImplementedError

    def save_example(self, filename, x, y, ts, p, version=None):
        raise NotImplementedError


class NReader(FileReader):
    """N-MNIST / N-Caltech101 binary format.

    Uses the native C++ decoder (``native/libevio.so``, OpenMP-batched) when
    built; falls back to the vectorized numpy decode below.
    """

    def read_example(self, filename):
        from async_ev_cnn_torch.data import native

        if native.available():
            return native.decode_ndata_file(filename)
        raw = np.fromfile(filename, dtype=np.uint8)
        return self.decode(raw)

    @staticmethod
    def decode(raw: np.ndarray):
        raw = raw[: raw.size - raw.size % 5].reshape(-1, 5).astype(np.uint32)
        x = raw[:, 0]
        y = raw[:, 1]
        p = (raw[:, 2] & 128) >> 7
        ts = ((raw[:, 2] & 127) << 16) | (raw[:, 3] << 8) | raw[:, 4]

        overflow = y == N_DATA_OVERFLOW_Y
        # each overflow marker bumps every *subsequent* event by 2^13 us
        ts = ts + N_DATA_OVERFLOW_INCREMENT * np.cumsum(overflow)
        keep = ~overflow
        x = x[keep].astype(np.int32)
        y = y[keep].astype(np.int32)
        ts = ts[keep].astype(np.int32)
        p = p[keep].astype(np.int32)
        return len(x), x, y, ts, p

    @staticmethod
    def encode(x, y, ts, p) -> np.ndarray:
        """Encode events, emitting y==240 overflow markers so timestamps
        past the 23-bit raw field round-trip (the old writer masked ts to
        23 bits silently — a >8.39 s recording re-read with timestamps
        jumping backwards).  Marker k-counts are the minimal monotone
        sequence with ``ts - k * 2**13`` inside the field, the inverse of
        :meth:`decode`'s cumulative-increment splice."""
        ts = np.asarray(ts, np.int64)
        over = ts - (2**23 - 1)
        k = np.zeros(len(ts), np.int64)
        if len(ts):
            k = np.maximum.accumulate(
                np.where(over > 0, -(-over // N_DATA_OVERFLOW_INCREMENT), 0)
            )
        raw_ts = (ts - k * N_DATA_OVERFLOW_INCREMENT).astype(np.uint32)
        n_markers = int(k[-1]) if len(k) else 0
        rows = np.zeros((len(ts) + n_markers, 5), np.uint8)
        if n_markers:
            pos = np.arange(len(ts)) + k  # event row after its markers
            rows[:, 1] = N_DATA_OVERFLOW_Y  # marker rows by default
        else:
            pos = slice(None)
        rows[pos, 0] = (np.asarray(x, np.int64) & 0xFF).astype(np.uint8)
        rows[pos, 1] = (np.asarray(y, np.int64) & 0xFF).astype(np.uint8)
        rows[pos, 2] = (
            ((np.asarray(p, np.int64) & 1) << 7) | ((raw_ts >> 16) & 0x7F)
        ).astype(np.uint8)
        rows[pos, 3] = ((raw_ts >> 8) & 0xFF).astype(np.uint8)
        rows[pos, 4] = (raw_ts & 0xFF).astype(np.uint8)
        return rows.reshape(-1)

    def save_example(self, filename, x, y, ts, p, version=None):
        self.encode(x, y, ts, p).tofile(filename)


_CAMERA_FORMATS = {
    # x_mask, x_shift, y_mask, y_shift, p_mask, p_shift
    "DVS128": (0xFE, 1, 0x7F00, 8, 0x1, 0),
    # DAVIS cameras share jAER's 32-bit apsDVS address layout:
    # y in bits 30:22, x in bits 21:12, polarity in bit 11.
    "DAVIS240": (0x003FF000, 12, 0x7FC00000, 22, 0x800, 11),
    "DAVIS346": (0x003FF000, 12, 0x7FC00000, 22, 0x800, 11),
}


class AerReader(FileReader):
    """AEDAT 2.0 / 3.1 (jAER / cAER)."""

    def __init__(self, camera: str = "DVS128"):
        self._camera = camera

    def _camera_format(self):
        try:
            return _CAMERA_FORMATS[self._camera]
        except KeyError:
            raise ValueError(f"unsupported camera {self._camera!r}") from None

    # ---- decoding ---------------------------------------------------------

    @staticmethod
    def _consume_header(f) -> str:
        """Skip the '#'-comment preamble, leaving ``f`` at the first payload
        byte, and return the version declared by the ``#!AER-DAT`` magic
        ("1.0" when absent, per the spec)."""
        version = "1.0"
        while True:
            mark = f.tell()
            line = f.readline()
            if not line.startswith(b"#"):
                f.seek(mark)
                return version
            if line.startswith(b"#!AER-DAT"):
                version = line[9:12].decode("ascii", "ignore")

    def read_example(self, filename):
        with open(filename, "rb") as f:
            version = self._consume_header(f)
            payload = np.fromfile(f, dtype=np.int32)
        if version == "2.0":
            return self._decode_20(payload)
        if version == "3.1":
            return self._decode_31(payload)
        raise NotImplementedError(f"AER-DAT version {version} not supported")

    def _decode_20(self, payload: np.ndarray):
        if self._camera == "DVS128":
            from async_ev_cnn_torch.data import native

            if native.available():
                out = native.decode_aedat20(payload.view(np.uint8))
                if out is not None:
                    return out
        # 2.0 payload is big-endian: reinterpret the bytes as '>i4' (a
        # bare byteswap() assumes a little-endian host and corrupts on a
        # big-endian one); drop a truncated file's odd trailing word so
        # addr and ts stay aligned (every other decoder here trims)
        data = payload.view(">i4").astype(np.int32)
        data = data[: data.size & ~1]
        addr = data[0::2]
        ts = data[1::2]
        if self._camera.startswith("DAVIS"):
            # jAER apsDVS streams interleave APS/IMU readout words flagged
            # by address bit 31; only bit-31-clear words are DVS events.
            dvs = (addr.astype(np.uint32) & np.uint32(0x80000000)) == 0
            addr, ts = addr[dvs], ts[dvs]
        x_mask, x_shift, y_mask, y_shift, p_mask, p_shift = self._camera_format()
        x = ((addr & x_mask) >> x_shift).astype(np.int32)
        y = ((addr & y_mask) >> y_shift).astype(np.int32)
        p = ((addr & p_mask) >> p_shift).astype(np.int32)
        return len(x), x, y, ts.astype(np.int32), p.astype(np.int32)

    def _decode_31(self, payload: np.ndarray):
        """Packet walk hardened for real cAER recordings (the reference only
        handles all-polarity streams, file_reader.py:129-132):

        * the packet type is read from the LOW 16 bits of word 0 per the
          AEDAT 3.1 spec (eventType int16, then eventSource int16,
          little-endian).  The reference reads the high 16 — i.e. the
          *source* field — which happens to work for source-1 polarity
          packets (both halves are 1) but misparses frame/IMU packets from
          source 1 as polarity.  Both this repo's and the reference's
          writers set both halves, so interop is unchanged.
        * non-polarity packets (frame, IMU, special) are skipped by their
          declared ``eventNumber * eventSize``;
        * ``eventTSOffset`` is honored: the timestamp int32 is taken at its
          declared byte offset within each event (the reference silently
          assumes offset 4);
        * truncated files decode every complete event and stop — no ragged
          array errors; corrupt headers (size <= 0 / not word-aligned /
          negative count) stop the walk instead of misparsing the rest;
        * the per-event timestamp word is masked to its 31 spec bits before
          the overflow-counter splice, so a corrupt sign bit cannot
          sign-extend into the int64 timestamp.

        Uses the native C++ packet walker (same semantics, gated bit-exact
        in tests/test_native.py) when built."""
        from async_ev_cnn_torch.data import native

        if native.available():
            out = native.decode_aedat31(payload.view(np.uint8))
            if out is not None:
                return out
        xs, ys, tss, ps = [], [], [], []
        pos = 0
        n = payload.size
        while pos + 7 <= n:
            header = payload[pos : pos + 7]
            pos += 7
            event_type = int(header[0]) & 0xFFFF
            event_size, ts_offset, ts_overflow, _, event_number, event_valid = (
                int(v) for v in header[1:]
            )
            if event_size <= 0 or event_size % 4 or event_number < 0:
                break  # corrupt header: stop rather than misparse the rest
            wpe = event_size // 4
            words = event_number * wpe
            avail = min(words, n - pos)
            body = payload[pos : pos + avail - avail % wpe]
            pos += words
            if not (event_valid and event_type == 1 and wpe >= 2):
                continue
            ts_col = (
                ts_offset // 4
                if 0 < ts_offset < event_size and ts_offset % 4 == 0
                else 1
            )
            data_col = 0  # the polarity word is word 0 (ts_col >= 1 above)
            mat = body.reshape(-1, wpe)
            data = mat[:, data_col]
            ts = mat[:, ts_col]
            x = ((data >> 17) & 0x1FFF).astype(np.int32)
            y = ((data >> 2) & 0x1FFF).astype(np.int32)
            p = ((data >> 1) & 0x1).astype(np.int32)
            valid = (data & 0x1).astype(bool)
            # mask the overflow counter to its 31 spec bits (parity with
            # the native walker; a corrupt sign bit must not produce
            # negative int64 timestamps)
            ts64 = (np.int64(ts_overflow & 0x7FFFFFFF) << 31) | (
                ts.astype(np.int64) & 0x7FFFFFFF
            )
            xs.append(x[valid])
            ys.append(y[valid])
            tss.append(ts64[valid])
            ps.append(p[valid])
        if not xs:
            z = np.zeros(0, np.int32)
            return 0, z, z, z.astype(np.int64), z
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        ts = np.concatenate(tss)
        p = np.concatenate(ps)
        return len(x), x, y, ts, p

    # ---- encoding ---------------------------------------------------------

    def _save_20(self, filename, x, y, ts, p):
        header = (
            "#!AER-DAT2.0\r\n"
            "# This is a raw AE data file - do not edit\r\n"
            "# Data format is int32 address, int32 timestamp (8 bytes total),"
            " repeated for each event\r\n"
            "# Timestamps tick is 1 us\r\n"
            "# created " + time.ctime() + "\r\n"
        )
        x_mask, x_shift, y_mask, y_shift, p_mask, p_shift = self._camera_format()
        addr = (
            ((np.asarray(y, np.uint32) << y_shift) & np.uint32(y_mask))
            | ((np.asarray(x, np.uint32) << x_shift) & np.uint32(x_mask))
            | ((np.asarray(p, np.uint32) << p_shift) & np.uint32(p_mask))
        )
        pairs = np.stack([addr, np.asarray(ts, np.uint32)], axis=-1)
        with open(filename, "wb") as f:
            f.write(header.encode())
            f.write(pairs.astype(">u4").tobytes())

    def _save_31(self, filename, x, y, ts, p):
        header = (
            "#!AER-DAT3.1\r\n#Format: RAW\r\n"
            f"#Source 1: {self._camera}\r\n"
            "#Start-Time: " + time.strftime("%Y-%m-%d %H:%M:%S (TZ%z)") + "\r\n"
            "#!END-HEADER\r\n"
        )
        ts = np.asarray(ts, np.int64)
        x = np.asarray(x, np.int64)
        y = np.asarray(y, np.int64)
        p = np.asarray(p, np.int64)
        overflow = (ts >> 31) & 0x7FFFFFFF
        # split into blocks of constant overflow counter
        boundaries = np.where(overflow[:-1] != overflow[1:])[0] + 1
        starts = np.concatenate([[0], boundaries])
        ends = np.concatenate([boundaries, [len(ts)]])
        chunks = []
        for s, e in zip(starts, ends):
            n = int(e - s)
            head = np.array(
                [1 << 16 | 1, 8, 4, int(overflow[s]), n, n, n], np.int32
            )
            data = (x[s:e] << 17) | (y[s:e] << 2) | (p[s:e] << 1) | 1
            body = np.stack(
                [data.astype(np.int32), (ts[s:e] & 0x7FFFFFFF).astype(np.int32)], axis=-1
            )
            chunks.append(head.tobytes())
            chunks.append(body.tobytes())
        with open(filename, "wb") as f:
            f.write(header.encode())
            for c in chunks:
                f.write(c)

    def save_example(self, filename, x, y, ts, p, version="3.1"):
        if version == "2.0":
            self._save_20(filename, x, y, ts, p)
        elif version == "3.1":
            self._save_31(filename, x, y, ts, p)
        else:
            raise NotImplementedError(f"AER-DAT writer for version {version}")


class NumpyReader(FileReader):
    """``.npy`` event arrays ``[N, 4]`` of (x, y, ts, p)."""

    def read_example(self, filename):
        events = np.load(filename)
        x, y, ts, p = events[:, 0], events[:, 1], events[:, 2], events[:, 3]
        return len(x), x, y, ts, p

    def save_example(self, filename, x, y, ts, p, version=None):
        np.save(filename, np.stack([x, y, ts, p], axis=-1))


def factory(file_format: str) -> FileReader:
    """Codec from a config string: 'n-data', 'aer-data[_CAMERA]', 'numpy',
    'evt2', 'evt3' (Prophesee RAW, data/evt.py)."""
    if file_format.startswith("n-data"):
        return NReader()
    if file_format.startswith("aer-data"):
        _, _, camera = file_format.partition("_")
        return AerReader(camera or "DVS128")
    if file_format.startswith("numpy"):
        return NumpyReader()
    if file_format.startswith("evt2"):
        from async_ev_cnn_torch.data.evt import Evt2Reader

        return Evt2Reader()
    if file_format.startswith("evt3"):
        from async_ev_cnn_torch.data.evt import Evt3Reader

        return Evt3Reader()
    raise ValueError(f"unknown file format {file_format!r}")
