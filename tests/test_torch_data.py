"""The port's data plane (async_ev_cnn_torch/data/*), runners
(utils/runner.py) and profiling helpers (utils/profiling.py) held against
the JAX package's on seeded files written as tests/test_data.py writes
them.

Tolerance: none.  The codecs and datasets are copied host numpy, so every
file written is byte-equal and every array read is equal to the JAX
package's; the native decoder (``native/evio.cc``, built here with the
host's g++ into ``tmp_path``) is held bit-equal to the numpy codecs, and
skipped only where the host has no C++ compiler.  The runner helpers pack
the same integers.  F4 (the detection reader's cache) is repaired in the
port: its test records the divergence.
"""

import os
import sys

import numpy as np
import pytest
import torch

from async_ev_cnn_torch.data import detection_reader as tdet
from async_ev_cnn_torch.data import event_reader as tev
from async_ev_cnn_torch.data import file_reader as tfr
from async_ev_cnn_torch.data import native as tnative
from async_ev_cnn_torch.data import prefetch as tprefetch
from async_ev_cnn_torch.data.evt import Evt2Reader as TEvt2
from async_ev_cnn_torch.data.evt import Evt3Reader as TEvt3
from async_ev_cnn_torch.utils import profiling as tprof
from async_ev_cnn_torch.utils import runner as trun
from async_ev_cnn_tpu.data import detection_reader as jdet
from async_ev_cnn_tpu.data import event_reader as jev
from async_ev_cnn_tpu.data import file_reader as jfr
from async_ev_cnn_tpu.data.evt import Evt2Reader as JEvt2
from async_ev_cnn_tpu.data.evt import Evt3Reader as JEvt3
from async_ev_cnn_tpu.utils import profiling as jprof
from async_ev_cnn_tpu.utils import runner as jrun

torch.set_num_threads(2)


def _events(rng, n=500, max_xy=128, max_ts=2**22):
    x = rng.randint(0, max_xy, n).astype(np.int32)
    y = rng.randint(0, min(max_xy, 239), n).astype(np.int32)  # 240 is reserved
    ts = np.sort(rng.randint(0, max_ts, n)).astype(np.int32)
    p = rng.randint(0, 2, n).astype(np.int32)
    return x, y, ts, p


def _codec_cases(rng):
    """(name, port codec, JAX codec, events, save kwargs), the formats of
    tests/test_data.py at its sizes."""
    yield "n-data", tfr.NReader(), jfr.NReader(), _events(rng), {}
    yield "n-data past 2^23 us", tfr.NReader(), jfr.NReader(), _events(rng, max_ts=2**25), {}
    yield ("aedat2.0", tfr.AerReader("DVS128"), jfr.AerReader("DVS128"),
           _events(rng, max_ts=2**28), {"version": "2.0"})
    x, y, ts, p = _events(rng, n=300, max_xy=1000)
    ts = ts.astype(np.int64) + np.int64(2**31) * (np.arange(300) >= 150)
    yield ("aedat3.1 with overflow", tfr.AerReader("DVS128"), jfr.AerReader("DVS128"),
           (x, y, ts, p), {"version": "3.1"})
    yield "numpy", tfr.NumpyReader(), jfr.NumpyReader(), _events(rng), {}
    n = 500
    evt = (rng.randint(0, 1280, n), rng.randint(0, 720, n),
           np.cumsum(rng.randint(0, 5000, n)), rng.randint(0, 2, n))
    evt = tuple(a.astype(np.int64) for a in evt)
    yield "evt2", TEvt2(), JEvt2(), evt, {}
    yield "evt3", TEvt3(), JEvt3(), evt, {}


@pytest.fixture
def numpy_codecs(monkeypatch):
    """The port's readers on their numpy codecs (no native library)."""
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", True)


@pytest.fixture
def native_lib(tmp_path, monkeypatch):
    """The native decoder built with the host's g++ into ``tmp_path`` and
    installed as the port's library; skipped only without a compiler."""
    if tnative.compiler() is None:
        pytest.skip("no host C++ compiler to build native/evio.cc")
    path = tnative.build(tmp_path / "native")
    assert path.parent == tmp_path / "native" and path.exists()
    monkeypatch.setattr(tnative, "_LIB", tnative.load(path))
    monkeypatch.setattr(tnative, "_TRIED", True)
    return path


def _assert_read_equal(got, want):
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("decoder", ["numpy", "native"])
def test_codecs_write_and_read_equal_jax(tmp_path, rng, request, decoder):
    """Each format written by the port byte-equal to the JAX package's file,
    and read back equal to the JAX package's numpy decode, by the port's
    numpy codecs and by its native decoder."""
    request.getfixturevalue("numpy_codecs" if decoder == "numpy" else "native_lib")
    for k, (name, tc, jc, ev, kw) in enumerate(_codec_cases(rng)):
        ext = ".npy" if name == "numpy" else ".dat"  # np.save appends .npy to a path without
        tp, jp = str(tmp_path / f"t{k}{ext}"), str(tmp_path / f"j{k}{ext}")
        tc.save_example(tp, *ev, **kw)
        jc.save_example(jp, *ev, **kw)
        if name == "numpy":
            np.testing.assert_array_equal(np.load(tp), np.load(jp))
        else:
            assert open(tp, "rb").read() == open(jp, "rb").read(), name
        _assert_read_equal(tc.read_example(tp), jc.read_example(jp))


def test_native_decoder_matches_numpy_codecs(tmp_path, rng, native_lib):
    """The library built into tmp_path (never into native/, where the JAX
    package's loader looks): every entry point bit-equal to the numpy
    codecs — n-data with overflow markers, the OpenMP batch, AEDAT 2.0 and
    3.1 payloads, EVT3 — and CRC-32C equal to the table loop."""
    from async_ev_cnn_torch.utils import tf_bundle

    assert native_lib.parent != tnative.SOURCE.parent
    paths = []
    for i in range(4):
        x, y, ts, p = _events(rng, n=200 + 37 * i)
        y[len(y) // 3] = 240  # an overflow marker row, dropped by both
        path = str(tmp_path / f"ex{i}.bin")
        np.frombuffer(tfr.NReader.encode(x, y, ts, p), np.uint8).tofile(path)
        paths.append(path)
    batch = tnative.decode_ndata_batch(paths)
    for path, got in zip(paths, batch):
        want = tfr.NReader.decode(np.fromfile(path, np.uint8))
        _assert_read_equal(tnative.decode_ndata_file(path), want)
        _assert_read_equal(got, want)
    data = bytes(rng.randint(0, 256, 4099).astype(np.uint8))
    table = tf_bundle._crc_tables()[0]
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    assert tnative.crc32c(data) == crc ^ 0xFFFFFFFF == tf_bundle._crc32c(data)


def test_native_builds_without_openmp(tmp_path, rng, monkeypatch):
    """A compiler that refuses -fopenmp (one without libgomp) builds the
    library without it, named apart, and its batch decode (then serial)
    stays bit-equal to the numpy codec."""
    if tnative.compiler() is None:
        pytest.skip("no host C++ compiler to build native/evio.cc")
    wrapper = tmp_path / "cxx-without-openmp"
    wrapper.write_text("#!/bin/sh\n"
                       "for a in \"$@\"; do [ \"$a\" = -fopenmp ] && exit 1; done\n"
                       f"exec {tnative.compiler()} \"$@\"\n")
    wrapper.chmod(0o755)
    monkeypatch.setenv("CXX", str(wrapper))
    path = tnative.build(tmp_path / "native")
    assert path == tnative.library_path(tmp_path / "native", openmp=False)
    assert path.name.startswith("libevio_") and "omp" not in path.name
    assert tnative.build(tmp_path / "native") == path  # found built
    monkeypatch.setattr(tnative, "_LIB", tnative.load(path))
    monkeypatch.setattr(tnative, "_TRIED", True)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"ex{i}.bin"))
        np.frombuffer(tfr.NReader.encode(*_events(rng, n=120 + i)), np.uint8).tofile(paths[-1])
    for path_i, got in zip(paths, tnative.decode_ndata_batch(paths)):
        _assert_read_equal(got, tfr.NReader.decode(np.fromfile(path_i, np.uint8)))


def test_native_switch_and_missing_compiler(tmp_path, monkeypatch):
    """ASYNC_EV_NATIVE=0 turns the library off; without a compiler there is
    no library and build() raises; the library's name follows the source
    and the flags, under build/native/ of the checkout."""
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", False)
    monkeypatch.setenv("ASYNC_EV_NATIVE", "0")
    assert tnative.get_lib() is None and not tnative.available()
    monkeypatch.setattr(tnative, "_TRIED", False)
    monkeypatch.setenv("ASYNC_EV_NATIVE", "1")
    monkeypatch.setenv("CXX", "no-such-compiler")
    assert tnative.get_lib() is None
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        tnative.build(tmp_path)
    assert tnative.library_path().parent == tnative.BUILD_DIR
    assert tnative.library_path().name.startswith("libevio_omp_")
    assert tnative.BUILD_DIR.parts[-2:] == ("build", "native")


def _class_dataset(tmp_path, rng, n_classes=2, per_class=4):
    root = tmp_path / "ds"
    for c in range(n_classes):
        d = root / f"class{c}"
        d.mkdir(parents=True)
        for i in range(per_class):
            tfr.NReader().save_example(str(d / f"ex{i}.bin"), *_events(rng, n=50 + 7 * i))
    return str(root)


def _detection_dataset(tmp_path, rng, max_xy=128):
    root = tmp_path / "det"
    (root / "annotations").mkdir(parents=True)
    for split, k in (("train", 4), ("test", 3), ("validation", 2)):
        (root / split).mkdir()
        for i in range(k):
            name = f"{split}_ex{i}"
            tfr.NReader().save_example(str(root / split / f"{name}.bin"),
                                       *_events(rng, n=40, max_xy=max_xy))
            np.save(str(root / "annotations" / f"{name}.npy"), rng.rand(2, 6).astype(np.float32))
    np.savez(str(root / "params.npz"), num_classes=5,
             label_to_idx=np.array([("a", 0), ("b", 1)], dtype=object))
    return str(root)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _prep(length, x, y, ts, p, bboxes):
    return length, np.stack([y, x, ts], -1).astype(np.int32), bboxes


def test_datasets_match_jax(tmp_path, rng, numpy_codecs):
    """EventDataset (stratified splits, padded batches, epoch wrap) and
    DetectionDataset (with a preprocessing fn and the cache) give the JAX
    package's splits and batches; a saved dataset restores into the other
    package's."""
    root = _class_dataset(tmp_path, rng)
    t = tev.EventDataset(root, validation_frac=0.25, test_frac=0.25, seed=7)
    j = jev.EventDataset(root, validation_frac=0.25, test_frac=0.25, seed=7)
    for split in ("train", "validation", "test"):
        assert t._files[split] == j._files[split]
    for _ in range(5):
        _assert_batches_equal(t.next_batch(2, dataset="train"), j.next_batch(2, dataset="train"))
    save = str(tmp_path / "ds_state.npz")
    t.save(save)
    j2 = jev.EventDataset.restore(save)
    _assert_batches_equal(t.next_batch(3, dataset="train"), j2.next_batch(3, dataset="train"))

    root = _detection_dataset(tmp_path, rng)
    t = tdet.factory(root, file_format="n-data", tmp_dir=str(tmp_path / "tc"))
    j = jdet.factory(root, file_format="n-data", tmp_dir=str(tmp_path / "jc"))
    assert (t.num_classes(), t.label_to_idx()) == (j.num_classes(), j.label_to_idx())
    for _ in range(4):  # the second epoch reads the cache
        _assert_batches_equal(t.next_batch(1, dataset="test", preprocessing_fn=_prep),
                              j.next_batch(1, dataset="test", preprocessing_fn=_prep))
    assert sorted(os.listdir(tmp_path / "tc")) == sorted(os.listdir(tmp_path / "jc"))


def test_f4_corrupt_detection_cache_heals(tmp_path, rng, numpy_codecs):
    """F4 (repaired in the port).  The JAX DetectionDataset writes its
    preprocess cache with a bare np.savez and reads it unguarded, so a
    truncated cache entry (a crash mid-write) fails every later load of
    the example.  The port's reader writes through a temporary file and
    os.replace and treats an entry that fails to load as a miss: it
    returns what the JAX reader returns on a clean cache and rewrites the
    entry whole."""
    root = _detection_dataset(tmp_path, rng)
    cache = str(tmp_path / "cache")
    t = tdet.factory(root, file_format="n-data", tmp_dir=cache)
    j = jdet.factory(root, file_format="n-data", tmp_dir=str(tmp_path / "clean"))
    filename, label = t._files["test"][0], None
    first = t._load_one(filename, label, _prep)
    (entry,) = [os.path.join(cache, f) for f in os.listdir(cache)]
    good = open(entry, "rb").read()
    with open(entry, "wb") as fh:  # a write cut short
        fh.write(good[: len(good) // 2])
    # the JAX reader on the same cache directory fails on the entry
    on_corrupt = jdet.factory(root, file_format="n-data", tmp_dir=cache)
    with pytest.raises(Exception):
        on_corrupt._load_one(filename, label, _prep)
    healed = t._load_one(filename, label, _prep)
    want = j._load_one(filename, label, _prep)
    for got in (first, healed):
        assert got[0] == want[0]
        _assert_batches_equal(got[1], want[1])
    assert open(entry, "rb").read() == good  # rewritten whole
    assert not [f for f in os.listdir(cache) if f.endswith(".tmp")]


def test_runner_helpers_match_jax(rng):
    """split_micro_batches, pack_chunks, pack_chunks_usec and pad_chunks_t
    give the JAX package's micro-batches and planes."""
    n = 300
    ev = np.stack([rng.randint(0, 20, n), rng.randint(0, 24, n),
                   np.cumsum(rng.randint(0, 30, n)), rng.randint(0, 2, n)], -1).astype(np.int32)
    for kw in (dict(batch_event_size=64), dict(batch_event_usec=500),
               dict(batch_event_size=7, batch_event_usec=40)):
        got, want = trun.split_micro_batches(ev, **kw), jrun.split_micro_batches(ev, **kw)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert trun.split_micro_batches(ev[:0], 8) == jrun.split_micro_batches(ev[:0], 8) == []
    for events in (ev, ev[:, :3], ev[:0]):
        for usec in (100, 2000):
            got = trun.pack_chunks_usec(events, 16, usec, device="cpu")
            want = jrun.pack_chunks_usec(events, 16, usec)
            _assert_batches_equal(got, want)
            _assert_batches_equal(trun.pad_chunks_t(got, got.y.shape[0] + 3),
                                  jrun.pad_chunks_t(want, want.y.shape[0] + 3))
        if len(events):
            _assert_batches_equal(trun.pack_chunks(events, 32, device="cpu"),
                                  jrun.pack_chunks(events, 32))
    with pytest.raises(ValueError, match="negative"):
        trun.pack_chunks_usec(np.array([[1, 2, -5]], np.int32), 4, 10, device="cpu")


def test_runners_on_a_detection_tree(tmp_path, rng, numpy_codecs):
    """EventRunner, FrameRunner and ScanEventRunner drive the port's models
    over a detection tree on the CPU, every micro-batch (or example) a
    timed step, and MultiStreamRunner two examples at once."""
    from collections import OrderedDict
    from types import SimpleNamespace

    from async_ev_cnn_torch.models.yolo import YoloEventTorch, YoloFrameTorch
    from async_ev_cnn_torch.utils.config import layers_dict

    root = _detection_dataset(tmp_path, rng, max_xy=16)
    args = SimpleNamespace(batch_size=1, reader_threads=1, batch_event_size=16,
                           batch_event_usec=None, leak=1e-4, frame_h=16, frame_w=20,
                           example_h=16, example_w=20, frame_delay=0)
    layers = layers_dict("conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,4 pool2=2,2 conv3=1,1,4,12")
    kw = dict(h_frame=16, w_frame=20, num_classes=2, cnn_layers=layers, cnn_padding="SAME",
              h_cells=4, w_cells=5, num_bbox=2, alpha=0.1, leak=1e-4, device="cpu")
    params = OrderedDict(
        w_conv1=rng.randn(3, 3, 1, 4).astype(np.float32), b_conv1=np.zeros(4, np.float32),
        w_conv2=rng.randn(3, 3, 4, 4).astype(np.float32), b_conv2=np.zeros(4, np.float32),
        w_conv3=rng.randn(1, 1, 4, 12).astype(np.float32), b_conv3=np.zeros(12, np.float32))
    for runner_cls, model_cls, mode in ((trun.EventRunner, YoloEventTorch, "dense"),
                                        (trun.FrameRunner, YoloFrameTorch, "dense"),
                                        (trun.ScanEventRunner, YoloEventTorch, "full")):
        model = model_cls(**kw, conv_mode=mode)
        model.set_weights(params)
        reader = tdet.factory(root, file_format="n-data")
        runner = runner_cls(args, reader, device="cpu")
        target = model if runner_cls is trun.ScanEventRunner else model.build_graph()
        stats = runner.run(target, max_examples=2, verbose=False)
        assert stats["events_per_sec"] > 0
        assert stats.get("steps", stats.get("examples")) == (
            2 if runner_cls is trun.ScanEventRunner else 6)  # 40 events: 3 x 16 each
    # the multi-stream runner over a world of 1 (started and ended by run)
    model = YoloEventTorch(**kw, conv_mode="full")
    model.set_weights(params)
    args.num_streams, args.window_budget_mb = 2, None
    runner = trun.MultiStreamRunner(args, tdet.factory(root, file_format="n-data"),
                                    device="cpu")
    stats = runner.run(model, max_examples=1, verbose=False)
    assert stats["examples"] == 2 and stats["events_per_sec"] > 0
    assert not torch.distributed.is_initialized()


def test_prefetch(tmp_path, rng, monkeypatch, numpy_codecs):
    """The thread Prefetcher delivers the dataset's batches; device_prefetch
    delivers batches (nested lists and dicts of arrays) in order, as
    tensors; process mode reports a missing dill plainly."""
    root = _class_dataset(tmp_path, rng)
    ds = tev.EventDataset(root, validation_frac=0, test_frac=0, seed=2)
    pf = ds.start_prefetch(2, dataset="train", preprocessing_fn=None, num_workers=2)
    try:
        for _ in range(5):
            assert pf.get(timeout=10)[0].shape == (2,)
    finally:
        pf.stop()
    batches = [[np.full(4, i, np.float32), {"ts": np.arange(3) + i, "n": i}] for i in range(5)]
    out = list(tprefetch.device_prefetch(iter(batches), size=2, device="cpu"))
    assert len(out) == 5
    for i, (a, d) in enumerate(out):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), batches[i][0])
        np.testing.assert_array_equal(d["ts"].numpy(), batches[i][1]["ts"])
        assert d["n"] == i
    monkeypatch.setitem(sys.modules, "dill", None)
    with pytest.raises(RuntimeError, match="dill"):
        tprefetch.Prefetcher(ds, 2, "train", None, mode="process")


def test_profiling_matches_jax(tmp_path, rng):
    """StepTimer's summary equals the JAX one's on the same steps; the
    layer profilers give one row a layer (and the fused pair as one, where
    the forward fuses it) and a TOTAL, as the JAX ones do; trace writes a
    Chrome trace."""
    from async_ev_cnn_torch.layers.network import EventNetwork
    from async_ev_cnn_torch.utils.config import layers_dict
    from async_ev_cnn_torch.utils.runner import pack_chunks

    t, j = tprof.StepTimer(), jprof.StepTimer()
    for dt, n in ((0.5, 10), (0.25, 20), (0.125, 5)):
        for timer in (t, j):
            timer.times.append(dt)
            timer.events.append(n)
    assert t.summary() == j.summary() and t.summary(0) == j.summary(0)

    ld = layers_dict("conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,8")
    params = {"w_conv1": torch.randn(4, 1, 3, 3), "b_conv1": torch.zeros(4),
              "w_conv2": torch.randn(8, 4, 3, 3), "b_conv2": torch.zeros(8)}
    ev = np.stack([rng.randint(0, 8, 64), rng.randint(0, 8, 64),
                   np.cumsum(rng.randint(1, 9, 64))], -1)
    chunks = pack_chunks(ev, 16, device="cpu")
    # 'full' runs conv1 and pool1 as one op: the conv and its pooled epilogue
    for mode, fn, names in (
            ("dense", tprof.profile_layers, ["intgr", "conv1", "pool1", "conv2", "TOTAL"]),
            ("full", tprof.profile_layers_parallel,
             ["integrate", "conv1+pool1 (epilogue)", "conv2", "TOTAL"])):
        net = EventNetwork(ld, 8, 8, 1e-3, padding="SAME", conv_mode=mode)
        rows = fn(net, params, chunks, reps=1, dispatches=1)
        assert [r[0] for r in rows] == names
        assert rows[-1][1] > 0
    with tprof.trace(str(tmp_path / "tr")) as prof:
        torch.ones(3).sum()
    assert prof is not None and (tmp_path / "tr" / "trace.json").exists()
    with tprof.trace(None) as prof:
        assert prof is None
