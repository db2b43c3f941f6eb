"""The port's contract guards: the data cases of tests/test_guards.py on
async_ev_cnn_torch, each beside the JAX package's answer to the same input.

int32 µs timestamp-wrap detection in the EVT2/EVT3 decoders (numpy and,
where g++ builds it, native) and in ``EventChunk.from_arrays``,
``data_transform``'s rebasing, header sniffing of binary payloads that
begin with '%', ``restore_stream_state``'s dtype check and
``YoloEventTorch``'s ``ts_window`` validation.  No tolerance: decodes and
transforms are compared exactly, refusals by type and message.
"""

from collections import OrderedDict
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from async_ev_cnn_torch.data import evt as tevt
from async_ev_cnn_torch.data import native as tnative
from async_ev_cnn_torch.layers.types import EventChunk as TChunk
from async_ev_cnn_torch.models.yolo import YoloEventTorch
from async_ev_cnn_torch.utils import checkpoint as tck
from async_ev_cnn_torch.utils.transforms import data_transform as t_transform
from async_ev_cnn_tpu.data import evt as jevt
from async_ev_cnn_tpu.layers.types import EventChunk as JChunk
from async_ev_cnn_tpu.utils.transforms import data_transform as j_transform


@pytest.fixture(scope="module")
def native_build(tmp_path_factory):
    if tnative.compiler() is None:
        return None
    return tnative.load(tnative.build(tmp_path_factory.mktemp("native")))


@pytest.fixture(params=["numpy", "native"])
def decoder(request, monkeypatch, native_build):
    """The port's readers on their numpy codecs, then on the native
    decoder (skipped without a host C++ compiler)."""
    lib = None
    if request.param == "native":
        if native_build is None:
            pytest.skip("no host C++ compiler to build native/evio.cc")
        lib = native_build
    monkeypatch.setattr(tnative, "_LIB", lib)
    monkeypatch.setattr(tnative, "_TRIED", True)
    return request.param


class TestTimestampWrapGuards:
    def test_evt2_decode_raises_past_int32(self, tmp_path, decoder):
        """EVT2 carries 34-bit wire times: one past 2^31 µs raises instead
        of wrapping into the int32 contract."""
        f = str(tmp_path / "big.raw")
        tevt.Evt2Reader().save_example(f, [1, 2], [3, 4],
                                       np.array([100, 2**31 + 5], np.int64), [0, 1])
        with pytest.raises(ValueError, match="int32"):
            tevt.Evt2Reader().read_example(f)
        with pytest.raises(ValueError, match="int32"):
            jevt.Evt2Reader().read_example(f)

    def test_evt2_decode_ok_at_boundary(self, tmp_path, decoder):
        f = str(tmp_path / "edge.raw")
        ts = np.array([100, 2**31 - 1], np.int64)
        tevt.Evt2Reader().save_example(f, [1, 2], [3, 4], ts, [0, 1])
        n, x, y, ts2, p = tevt.Evt2Reader().read_example(f)
        assert n == 2
        np.testing.assert_array_equal(ts2.astype(np.int64), ts)
        for a, b in zip((n, x, y, ts2, p), jevt.Evt2Reader().read_example(f)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_evt3_decode_raises_past_int32(self, tmp_path, decoder):
        """EVT3's 24-bit wire time unwraps without bound: past 2^31 µs the
        active decoder raises."""
        f = str(tmp_path / "big3.raw")
        tevt.Evt3Reader().save_example(f, [1, 2], [3, 4],
                                       np.array([100, 2**31 + 77], np.int64), [0, 1])
        with pytest.raises(ValueError, match="int32"):
            tevt.Evt3Reader().read_example(f)

    def test_evt3_decoders_raise_on_full_wrap(self, native_build):
        """129 full 12-bit TIME_HIGH wraps unwrap past int32 µs: both the
        numpy and the native decoder raise, also where an int32 time would
        wrap all the way back to positive."""
        words = [(0x8 << 12) | 1, (0x6 << 12) | 5, (0x0 << 12) | 3, (0x2 << 12) | 4]
        for _ in range(129):
            words += [(0x8 << 12) | 0xFFF, (0x8 << 12) | 0x000]
        words += [(0x8 << 12) | 5, (0x6 << 12) | 1, (0x2 << 12) | 7]
        payload = np.array(words, "<u2").tobytes()
        for decode in (tevt.Evt3Reader._decode, jevt.Evt3Reader._decode):
            with pytest.raises(ValueError, match="int32"):
                decode(np.frombuffer(payload, "<u2"))
        if native_build is not None:
            saved = tnative._LIB, tnative._TRIED
            tnative._LIB, tnative._TRIED = native_build, True
            try:
                with pytest.raises(ValueError, match="int32"):
                    tnative.decode_evt3(payload)
            finally:
                tnative._LIB, tnative._TRIED = saved

    @pytest.mark.parametrize("ts, match", [
        (np.array([2**31 + 3], np.int64), "rebase"),
        (np.array([-5], np.int32), "negative timestamp"),
        (np.array([-5], np.int64), "negative timestamp"),
    ])
    def test_event_chunk_from_arrays_guards(self, ts, match):
        """Wrapped and negative timestamps (int32 inputs included) raise in
        both packages, with the same message."""
        for chunk in (lambda: TChunk.from_arrays([1], [2], ts, capacity=4, device="cpu"),
                      lambda: JChunk.from_arrays([1], [2], ts, capacity=4)):
            with pytest.raises(ValueError, match=match):
                chunk()

    def test_event_chunk_from_arrays_accepts_int64_in_range(self):
        ch = TChunk.from_arrays([1], [2], np.array([2**31 - 1], np.int64), capacity=4,
                                device="cpu")
        assert ch.ts.dtype == torch.int32 and int(ch.ts[0]) == 2**31 - 1
        want = JChunk.from_arrays([1], [2], np.array([2**31 - 1], np.int64), capacity=4)
        for got, ref in zip(ch, want):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    def test_data_transform_rebases_and_guards(self):
        args = SimpleNamespace(frame_h=8, frame_w=8, example_h=8, example_w=8)
        base = np.int64(2**31 + 1000)
        ts = base + np.array([0, 10, 20], np.int64)
        inputs = (np.int64(3), np.array([1, 2, 3]), np.array([1, 2, 3]), ts,
                  np.array([0, 1, 0]), None, args)
        l, events = t_transform(*inputs)
        np.testing.assert_array_equal(events[:, 2], [0, 10, 20])
        jl, jevents = j_transform(*inputs)
        assert l == jl
        np.testing.assert_array_equal(events, jevents)
        bad = (np.int64(2), np.array([1, 2]), np.array([1, 2]),
               np.array([0, 2**31 + 5], np.int64), np.array([0, 1]), None, args)
        for transform in (t_transform, j_transform):
            with pytest.raises(ValueError, match="int32"):
                transform(*bad)


class TestHeaderSniffing:
    def test_binary_payload_starting_with_percent_kept(self, tmp_path, decoder):
        """A headerless EVT2 stream whose first byte is 0x25 ('%') keeps its
        payload: there is no printable-ASCII line to strip."""
        word = (0x1 << 28) | (7 << 22) | (5 << 11) | 0x25
        payload = np.array([word], "<u4").tobytes()
        assert payload[0:1] == b"%"
        f = str(tmp_path / "headerless.raw")
        with open(f, "wb") as fh:
            fh.write(payload)
        n, x, y, ts, p = tevt.Evt2Reader().read_example(f)
        assert n == 1
        assert int(x[0]) == 5 and int(y[0]) == 0x25 and int(p[0]) == 1
        for a, b in zip((n, x, y, ts, p), jevt.Evt2Reader().read_example(f)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    @pytest.mark.parametrize("data, payload", [
        (b"% evt 3.0\n% format EVT3\n\x01\x02\x03\x04", b"\x01\x02\x03\x04"),
        (b"%\x01\x02\x03", b"%\x01\x02\x03"),
        (b"% evt 2.0\n", b""),
    ])
    def test_split_header_matches_jax(self, data, payload):
        assert tevt._split_header(data) == payload == jevt._split_header(data)


def test_restore_stream_state_rejects_wrong_dtype(tmp_path):
    """A state saved with float32 and int32 leaves refuses a float64
    structure, in the port as in the JAX package."""
    from async_ev_cnn_tpu.utils.checkpoint import restore_stream_state as j_restore

    state = (torch.zeros((2, 2), dtype=torch.float32), torch.tensor(7, dtype=torch.int32))
    path = str(tmp_path / "st.npz")
    tck.save_stream_state(path, state)
    wrong = (torch.zeros((2, 2), dtype=torch.float64), torch.tensor(0, dtype=torch.int32))
    with pytest.raises(ValueError, match="dtype"):
        tck.restore_stream_state(path, wrong)
    with pytest.raises(ValueError, match="dtype"):
        j_restore(path, (np.zeros((2, 2), np.float64), np.int32(0)))
    back = tck.restore_stream_state(path, state)
    assert back[0].dtype == torch.float32 and int(back[1]) == 7


@pytest.mark.parametrize("ts_window, ok", [(-3, False), (0, False), (8, True)])
def test_yolo_ts_window_validation(ts_window, ok):
    from async_ev_cnn_tpu.models.yolo import YoloEventJax

    kw = dict(h_frame=16, w_frame=16, num_classes=2,
              cnn_layers=OrderedDict(conv1=[3, 3, 1, 4]), cnn_padding="SAME",
              h_cells=2, w_cells=2, num_bbox=1, alpha=0.1, leak=1e-4, conv_mode="full")
    builds = (lambda: YoloEventTorch(**kw, ts_window=ts_window, device="cpu"),
              lambda: YoloEventJax(**kw, ts_window=ts_window))
    for build in builds:
        if ok:
            build()
        else:
            with pytest.raises(ValueError, match="ts_window"):
                build()
