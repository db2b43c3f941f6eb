"""Fuzz the port's file codecs (async_ev_cnn_torch/data): the twin of
tests/test_fuzz_codecs.py, with its parametrisation, and the garbage and
random-word cases of tests/test_native.py for the port's native decoder.

Arbitrary bytes must decode to something or raise cleanly, never hang or
corrupt memory.  Every file is read twice by the port, by its numpy codecs
and by its native decoder (``native/evio.cc`` built with the host's g++
into a temporary directory once for the module; the native half is
skipped where there is no compiler), and each outcome, the decoded arrays
or the exception's type, is held equal to the JAX package's numpy decode
of the same bytes.  No tolerance: decodes are compared exactly.
"""

import numpy as np
import pytest

from async_ev_cnn_torch.data import evt as tevt
from async_ev_cnn_torch.data import file_reader as tfr
from async_ev_cnn_torch.data import native as tnative
from async_ev_cnn_tpu.data import evt as jevt
from async_ev_cnn_tpu.data import file_reader as jfr
from async_ev_cnn_tpu.data import native as jnative


@pytest.fixture(scope="module")
def native_build(tmp_path_factory):
    """The port's native library built once for the module, or None
    without a host C++ compiler."""
    if tnative.compiler() is None:
        return None
    return tnative.load(tnative.build(tmp_path_factory.mktemp("native")))


@pytest.fixture(autouse=True)
def jax_numpy_codecs(monkeypatch):
    """The JAX package's readers on their numpy codecs: the reference."""
    monkeypatch.setattr(jnative, "available", lambda: False)


def _outcome(read):
    """``read()``'s arrays, or the type of what it raised."""
    try:
        return tuple(np.asarray(a) for a in read())
    except Exception as err:  # noqa: BLE001 - the outcome is the type
        return type(err)


def _same(got, want, what):
    if isinstance(want, type) or isinstance(got, type):
        assert got == want, f"{what}: {got} against the JAX package's {want}"
        return
    assert len(got) == len(want), what
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=what)


def _read_port(monkeypatch, native_build, read):
    """``read()`` of the port by its numpy codecs and, where built, by its
    native decoder: ``{decoder: outcome}``."""
    out = {}
    for decoder, lib in (("numpy", None), ("native", native_build)):
        if decoder == "native" and lib is None:
            continue
        monkeypatch.setattr(tnative, "_LIB", lib)
        monkeypatch.setattr(tnative, "_TRIED", True)
        out[decoder] = _outcome(read)
    return out


def _read_both(monkeypatch, native_build, port_read, jax_read):
    """The port's outcomes, each held equal to the JAX package's; returns
    the port's numpy outcome."""
    want = _outcome(jax_read)
    got = _read_port(monkeypatch, native_build, port_read)
    for decoder, outcome in got.items():
        _same(outcome, want, decoder)
    return got["numpy"]


@pytest.mark.parametrize("size", [0, 1, 4, 5, 37, 1024])
def test_ndata_fuzz(tmp_path, rng, monkeypatch, native_build, size):
    path = str(tmp_path / "f.bin")
    rng.randint(0, 256, size, dtype=np.int64).astype(np.uint8).tofile(path)
    got = _read_both(monkeypatch, native_build, lambda: tfr.NReader().read_example(path),
                     lambda: jfr.NReader().read_example(path))
    l, x, y, ts, p = got
    assert l == len(x) == len(y) == len(ts) == len(p)
    assert l <= size // 5


@pytest.mark.parametrize("header", [b"", b"#!AER-DAT2.0\r\n", b"#!AER-DAT3.1\r\n#!END-HEADER\r\n"])
def test_aer_fuzz(tmp_path, rng, monkeypatch, native_build, header):
    path = str(tmp_path / "f.aedat")
    payload = rng.randint(0, 256, 256, dtype=np.int64).astype(np.uint8).tobytes()
    with open(path, "wb") as f:
        f.write(header + payload)
    got = _read_both(monkeypatch, native_build,
                     lambda: tfr.AerReader("DVS128").read_example(path),
                     lambda: jfr.AerReader("DVS128").read_example(path))
    if not header:  # version 1.0 assumed -> clean NotImplementedError
        assert got is NotImplementedError
        return
    assert got[0] == len(got[1])


def test_numpy_reader_garbage(tmp_path):
    path = str(tmp_path / "f.npy")
    with open(path, "wb") as f:
        f.write(b"not an npy file at all")
    with pytest.raises(Exception):
        tfr.NumpyReader().read_example(path)
    assert _outcome(lambda: tfr.NumpyReader().read_example(path)) == \
        _outcome(lambda: jfr.NumpyReader().read_example(path))


@pytest.mark.parametrize("size", [0, 1, 2, 3, 64, 1023])
@pytest.mark.parametrize("header", [b"", b"% evt 3.0\n% format EVT3\n", b"% truncated-no-newline"])
def test_evt_fuzz(tmp_path, rng, monkeypatch, native_build, size, header):
    path = str(tmp_path / "f.raw")
    payload = rng.randint(0, 256, size, dtype=np.int64).astype(np.uint8).tobytes()
    with open(path, "wb") as f:
        f.write(header + payload)
    for tcodec, jcodec in ((tevt.Evt2Reader, jevt.Evt2Reader),
                           (tevt.Evt3Reader, jevt.Evt3Reader)):
        got = _read_both(monkeypatch, native_build, lambda: tcodec().read_example(path),
                         lambda: jcodec().read_example(path))
        # random bytes can assemble wire times past the int32 µs contract:
        # a clean ValueError is a valid outcome (the reader skips the file)
        if got is ValueError:
            continue
        assert not isinstance(got, type), got
        assert got[0] == len(got[1]) == len(got[2]) == len(got[3]) == len(got[4])


# ---- EVT3 structured adversaries --------------------------------------------


def _evt3_file(tmp_path, words, name="adv.raw"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(b"% evt 3.0\n% format EVT3\n")
        f.write(np.asarray(words, dtype="<u2").tobytes())
    return path


def _w(typ, val):
    return (typ << 12) | (val & 0xFFF)


def _decode_both(tmp_path, monkeypatch, native_build, words):
    """Decode through read_example (numpy and native) and the numpy
    decoder directly, each equal to the JAX package's decode; returns the
    decode."""
    path = _evt3_file(tmp_path, words)
    fallback = tevt.Evt3Reader._decode(np.asarray(words, dtype="<u2"))
    want = jevt.Evt3Reader._decode(np.asarray(words, dtype="<u2"))
    _same(tuple(np.asarray(a) for a in fallback), tuple(np.asarray(a) for a in want),
          "_decode")
    _read_both(monkeypatch, native_build, lambda: tevt.Evt3Reader().read_example(path),
               lambda: jevt.Evt3Reader().read_example(path))
    return fallback


def test_evt3_truncated_vector_stream(tmp_path, monkeypatch, native_build):
    """A VECT_BASE_X followed by a vector validity word cut off mid-
    sequence, and a validity word with no preceding base (base 0): both
    decode deterministically, coords in range."""
    words = [
        _w(0x8, 0x001), _w(0x6, 0x100), _w(0x0, 5),      # time + y
        _w(0x3, 40),                                     # base_x = 40
        _w(0x4, 0b000000000101),                         # events at 40, 42
        _w(0x3, 100),                                    # cut after a base
    ]
    n, x, y, ts, p = _decode_both(tmp_path, monkeypatch, native_build, words)
    assert n == 2
    np.testing.assert_array_equal(x, [40, 42])
    np.testing.assert_array_equal(y, [5, 5])
    orphan = [_w(0x8, 0x001), _w(0x6, 0x000), _w(0x5, 0b10000001)]
    n, x, y, ts, p = _decode_both(tmp_path, monkeypatch, native_build, orphan)
    assert n == 2
    np.testing.assert_array_equal(x, [0, 7])
    assert (y == 0).all()


def test_evt3_vector_advance_across_bases(tmp_path, monkeypatch, native_build):
    """base_x advances by 12/8 per vector word and resets at each new
    VECT_BASE_X."""
    words = [
        _w(0x8, 0x000), _w(0x6, 0x010), _w(0x0, 3),
        _w(0x3, 24),
        _w(0x4, 0b1), _w(0x4, 0b1), _w(0x5, 0b1),     # 24, 36, 48
        _w(0x3, 200),
        _w(0x5, 0b10),                                 # 201
    ]
    n, x, y, ts, p = _decode_both(tmp_path, monkeypatch, native_build, words)
    np.testing.assert_array_equal(x, [24, 36, 48, 201])


def test_evt3_time_base_regression_wraps_forward(tmp_path, monkeypatch, native_build):
    """A genuine 24-bit rollover unwraps forward."""
    words = [
        _w(0x8, 0xFFF), _w(0x6, 0x800), _w(0x0, 1), _w(0x2, 10),
        _w(0x8, 0x000), _w(0x6, 0x001), _w(0x2, 11),
    ]
    n, x, y, ts, p = _decode_both(tmp_path, monkeypatch, native_build, words)
    assert n == 2
    assert ts[1] > ts[0]
    assert ts[1] == ((0x1000 << 12) | 0x001)


def test_evt3_oscillating_time_high_raises_not_wraps(tmp_path, monkeypatch, native_build):
    """An oscillating TIME_HIGH accumulates fake rollovers until the time
    leaves the int32 µs contract: every decoder refuses."""
    words = []
    for _ in range(300):
        words += [_w(0x8, 0x800), _w(0x8, 0x000)]
    words += [_w(0x6, 0x000), _w(0x0, 0), _w(0x2, 1)]
    path = _evt3_file(tmp_path, words)
    got = _read_port(monkeypatch, native_build, lambda: tevt.Evt3Reader().read_example(path))
    assert set(got.values()) == {ValueError}
    with pytest.raises(ValueError, match="int32"):
        tevt.Evt3Reader._decode(np.asarray(words, dtype="<u2"))


def test_evt3_ignored_packet_types_do_not_perturb_state(tmp_path, monkeypatch, native_build):
    """EXT_TRIGGER / OTHERS / CONTINUED words between every valid word
    leave the decode unchanged."""
    base = [
        _w(0x8, 0x002), _w(0x6, 0x123), _w(0x0, 7), _w(0x2, 0x811),
        _w(0x3, 50), _w(0x4, 0b11), _w(0x0, 9), _w(0x2, 30),
    ]
    ref = _decode_both(tmp_path, monkeypatch, native_build, base)
    noise_types = [0xA, 0xE, 0x7, 0xF]
    noisy = []
    for i, w in enumerate(base):
        noisy.append(_w(noise_types[i % 4], 0xABC))
        noisy.append(w)
    noisy.append(_w(0xE, 0x123))
    got = _decode_both(tmp_path, monkeypatch, native_build, noisy)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_evt3_native_matches_numpy_on_random_words(rng, native_build):
    """Differential fuzz: the port's native EVT3 decoder and the JAX
    package's numpy decoder agree exactly on arbitrary word soup,
    refusing the same streams."""
    if native_build is None:
        pytest.skip("no host C++ compiler to build native/evio.cc")
    for _ in range(20):
        words = rng.randint(0, 2**16, size=rng.randint(1, 400),
                            dtype=np.int64).astype("<u2")
        a = _outcome(lambda: jevt.Evt3Reader._decode(words))
        b = _outcome(lambda: _native(native_build, tnative.decode_evt3, words.tobytes()))
        _same(b, a, "the port's native against the JAX package's numpy")


def test_evt2_corrupt_types_and_truncation(tmp_path, monkeypatch, native_build):
    """EVT2: unknown type nibbles are skipped without perturbing the
    TIME_HIGH state; a payload truncated mid-word drops only the ragged
    tail bytes."""
    def w32(typ, payload):
        return (typ << 28) | (payload & 0x0FFFFFFF)

    words = [
        w32(0x8, 5), w32(0xA, 0xDEAD),
        w32(0x0, (3 << 22) | (7 << 11) | 9),
        w32(0xB, 0xBEEF), w32(0x3, 0x123),
        w32(0x1, (4 << 22) | (8 << 11) | 2),
    ]
    path = str(tmp_path / "adv2.raw")
    with open(path, "wb") as f:
        f.write(b"% evt 2.0\n")
        f.write(np.asarray(words, dtype="<u4").tobytes() + b"\x01\x02")
    n, x, y, ts, p = _read_both(monkeypatch, native_build,
                                lambda: tevt.Evt2Reader().read_example(path),
                                lambda: jevt.Evt2Reader().read_example(path))
    assert n == 2
    np.testing.assert_array_equal(x, [7, 8])
    np.testing.assert_array_equal(y, [9, 2])
    np.testing.assert_array_equal(ts, [(5 << 6) | 3, (5 << 6) | 4])
    np.testing.assert_array_equal(p, [0, 1])


# ---- the native decoder on garbage (tests/test_native.py's fuzz cases) ------


def _native(lib, fn, *args):
    """``fn(*args)`` of data/native.py with ``lib`` as its library."""
    saved = tnative._LIB, tnative._TRIED
    tnative._LIB, tnative._TRIED = lib, True
    try:
        return fn(*args)
    finally:
        tnative._LIB, tnative._TRIED = saved


@pytest.mark.parametrize("size", [0, 1, 4, 5, 37, 1024, 4099])
def test_native_ndata_garbage_matches_numpy(tmp_path, rng, native_build, size):
    """Random bytes as an n-data file (overflow rows included where the
    bytes make them): the port's native file and batch decoders give the
    JAX package's numpy decode exactly."""
    if native_build is None:
        pytest.skip("no host C++ compiler to build native/evio.cc")
    path = str(tmp_path / "g.bin")
    raw = rng.randint(0, 256, size, dtype=np.int64).astype(np.uint8)
    raw.tofile(path)
    want = jfr.NReader.decode(raw)
    _same(tuple(np.asarray(a) for a in _native(native_build, tnative.decode_ndata_file, path)),
          tuple(np.asarray(a) for a in want), "decode_ndata_file")
    (batch,) = _native(native_build, tnative.decode_ndata_batch, [path])
    _same(tuple(np.asarray(a) for a in batch), tuple(np.asarray(a) for a in want),
          "decode_ndata_batch")


@pytest.mark.parametrize("size", [0, 2, 3, 8, 64, 1000])
def test_native_aedat_garbage_matches_numpy(tmp_path, rng, monkeypatch, native_build, size):
    """Random AEDAT 2.0 and 3.1 payloads: the port's native decoders and
    its numpy codecs agree on the decode or both raise, and the JAX
    package's numpy decode with them."""
    payload = rng.randint(0, 256, size, dtype=np.int64).astype(np.uint8).tobytes()
    for header in (b"#!AER-DAT2.0\r\n", b"#!AER-DAT3.1\r\n#!END-HEADER\r\n"):
        path = str(tmp_path / "g.aedat")
        with open(path, "wb") as f:
            f.write(header + payload)
        _read_both(monkeypatch, native_build,
                   lambda: tfr.AerReader("DVS128").read_example(path),
                   lambda: jfr.AerReader("DVS128").read_example(path))


def test_native_crc32c_random_bytes(rng, monkeypatch, native_build):
    """The port's native CRC-32C against the JAX package's pure-Python
    table loop on random buffers of every length class."""
    from async_ev_cnn_tpu.utils import tf_bundle as jtf

    if native_build is None:
        pytest.skip("no host C++ compiler to build native/evio.cc")
    # the JAX package's table loop, not its native library
    monkeypatch.setattr(jnative, "crc32c", lambda data: None)
    for n in (0, 1, 3, 4, 7, 8, 63, 64, 65, 1000, 4097):
        data = rng.randint(0, 256, n, dtype=np.int64).astype(np.uint8).tobytes()
        assert _native(native_build, tnative.crc32c, data) == jtf._crc32c(data), n
