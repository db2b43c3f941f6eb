"""The port's checkpoints held against the JAX package: weights (.npz and
TF bundle, async_ev_cnn_torch/utils/checkpoint.py and utils/tf_bundle.py),
the stream state, and ``YoloEventTorch(checkpoint=...)``.

Tolerance: none.  Arrays read back are compared bit for bit (float32 bit
patterns), a bundle written by the port byte for byte against the JAX
package's, a restored stream state leaf by leaf bit for bit; only the
outputs of a network run on after a restore are held within 1e-4, the
conv-stack contract of tests/test_equivalence.py.
"""

import os
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from async_ev_cnn_torch.layers import network as tnet
from async_ev_cnn_torch.layers.types import EventChunk as TChunk
from async_ev_cnn_torch.models.yolo import YoloEventTorch
from async_ev_cnn_torch.utils import checkpoint as tck
from async_ev_cnn_torch.utils import tf_bundle as tbundle
from async_ev_cnn_torch.utils.weights import params_from_jax
from async_ev_cnn_tpu.layers import network as jnet
from async_ev_cnn_tpu.layers.types import EventChunk as JChunk
from async_ev_cnn_tpu.models.yolo import YoloEventJax
from async_ev_cnn_tpu.utils import checkpoint as jck
from async_ev_cnn_tpu.utils import tf_bundle as jbundle
from async_ev_cnn_tpu.utils.config import layers_dict

torch.set_num_threads(2)
TOL = 1e-4
PACKAGES = {"jax": jck, "torch": tck}
DIRECTIONS = [("jax", "torch"), ("torch", "jax")]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same_arrays(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=k)


@pytest.fixture
def weights(rng):
    return {
        "w_conv1": rng.randn(3, 3, 1, 4).astype(np.float32),
        "b_conv1": rng.randn(4).astype(np.float32),
        "w_conv2": rng.randn(3, 3, 4, 6).astype(np.float32),
        "b_conv2": rng.randn(6).astype(np.float32),
        "w_fc1": rng.randn(12, 5).astype(np.float64),
        "counter": np.arange(7, dtype=np.int64),
        "mask": rng.rand(3, 2) > 0.5,
        "small": rng.randint(0, 255, (4,)).astype(np.uint8),
        "half": rng.randn(5).astype(np.float16),
        "step": np.array([1234], np.int32),
    }


# ---- weights ---------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
@pytest.mark.parametrize("name", ["weights.npz", "weights.ckpt"])
def test_npz_round_trip_across_packages(tmp_path, weights, writer, reader, name):
    """.npz written by one package loads in the other, with or without the
    extension (save_params writes the exact path)."""
    path = str(tmp_path / name)
    PACKAGES[writer].save_params(path, weights)
    assert os.path.exists(path)
    _assert_same_arrays(PACKAGES[reader].load_params(path), weights)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_bundle_round_trip_across_packages(tmp_path, weights, writer, reader):
    prefix = str(tmp_path / "export.ckpt")
    PACKAGES[writer].save_params_tf(prefix, weights)
    _assert_same_arrays(PACKAGES[reader].load_params(prefix), weights)
    # the directory resolves through the 'checkpoint' marker in both
    assert PACKAGES[reader].latest_checkpoint(str(tmp_path)) == prefix
    assert tbundle.list_variables(prefix) == jbundle.list_variables(prefix)


def test_port_bundle_byte_identical_to_jax(tmp_path, weights):
    """The same tensors written by both packages give the same three files,
    byte for byte (index with its CRC-32C trailers, data shard, marker)."""
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "torch")
    jck.save_params_tf(str(tmp_path / "jax" / "model"), weights)
    tck.save_params_tf(str(tmp_path / "torch" / "model"), weights)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch")) == [
        "checkpoint", "model.data-00000-of-00001", "model.index"]
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == (tmp_path / "torch" / n).read_bytes(), n


def _snappy(raw: bytes, copy_tail: int = 0) -> bytes:
    """A valid snappy stream: ``raw`` as literals of at most 60 bytes, then,
    with ``copy_tail``, one overlapping copy of ``copy_tail`` bytes at offset
    4 (which repeats raw's last 4 bytes)."""
    out = bytearray()
    tbundle._write_varint(out, len(raw) + copy_tail)
    for i in range(0, len(raw), 60):
        lit = raw[i:i + 60]
        out.append((len(lit) - 1) << 2)
        out += lit
    if copy_tail:
        out.append(((copy_tail - 1) << 2) | 2)  # copy, 2-byte offset
        out += struct.pack("<H", 4)
    return bytes(out)


def _multiblock_bundle(prefix: str, tensors: dict, per_block: int) -> int:
    """A bundle whose index holds its entries in several data blocks, every
    other one snappy-compressed, as TensorFlow writes large checkpoints;
    the data shard and entries are the writer's own.  Returns the number of
    blocks."""
    tbundle.save_tensor_bundle(prefix, tensors)
    entries = sorted(tbundle.read_sstable(prefix + ".index").items())
    out = bytearray()
    index = []
    for n, i in enumerate(range(0, len(entries), per_block)):
        group = entries[i:i + per_block]
        block = tbundle._write_block(group)[:-5]  # without its trailer
        ctype = n % 2
        payload = _snappy(block) if ctype else block
        index.append((group[-1][0] + b"\xff",
                      tbundle._encode_handle(len(out), len(payload))))
        out += payload + bytes([ctype]) + struct.pack(
            "<I", tbundle._masked_crc(payload + bytes([ctype])))
    meta = tbundle._write_block([])
    meta_handle = tbundle._encode_handle(len(out), len(meta) - 5)
    out += meta
    index_block = tbundle._write_block(index)
    footer = meta_handle + tbundle._encode_handle(len(out), len(index_block) - 5)
    out += index_block
    out += footer + b"\x00" * (40 - len(footer)) + struct.pack("<Q", tbundle._TABLE_MAGIC)
    with open(prefix + ".index", "wb") as f:
        f.write(bytes(out))
    return len(index)


def test_multiblock_bundle(tmp_path, rng):
    """Enough variables for several index blocks and prefix-compressed keys:
    both readers return the same arrays."""
    tensors = {f"w_conv{i:03d}": rng.randn(7, 11).astype(np.float32) for i in range(120)}
    prefix = str(tmp_path / "many")
    assert _multiblock_bundle(prefix, tensors, per_block=16) == 8
    got = tck.load_params(prefix)
    _assert_same_arrays(got, tensors)
    _assert_same_arrays(got, jck.load_params(prefix))


def test_snappy_matches_jax(rng):
    raw = rng.randint(0, 256, 500).astype(np.uint8).tobytes()
    stream = _snappy(raw, copy_tail=10)
    want = raw + (raw[-4:] * 3)[:10]
    assert tbundle._snappy_decompress(stream) == jbundle._snappy_decompress(stream) == want
    for data in (b"", raw, raw * 7):
        assert tbundle._crc32c(data) == jbundle._crc32c(data)


@pytest.mark.parametrize("where", ["data", "index"])
def test_corrupt_bundle_refused(tmp_path, weights, where):
    """A flipped byte in the data shard fails the tensor's CRC-32C, one in
    the index fails its block's: both readers refuse alike, and the port's
    load_params passes the refusal on (the JAX package's tries TensorFlow
    next where it is installed; the port has no such fallback)."""
    prefix = str(tmp_path / "ckpt")
    tck.save_params_tf(prefix, weights)
    path = prefix + (".data-00000-of-00001" if where == "data" else ".index")
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2 if where == "data" else 3] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    for load in (tck.load_params, tbundle.load_tensor_bundle, jbundle.load_tensor_bundle):
        with pytest.raises(ValueError, match="checksum"):
            load(prefix)


def test_latest_checkpoint(tmp_path, weights):
    """Newest .npz or .index by mtime, crashed '.tmp.npz' writes skipped, the
    TF marker first, and an empty directory refused, as in the JAX package."""
    d = tmp_path / "run"
    os.makedirs(d)
    for ck in (tck, jck):
        with pytest.raises(FileNotFoundError):
            ck.latest_checkpoint(str(d))
    tck.save_params(str(d / "a.npz"), weights)
    tck.save_params_tf(str(d / "b"), weights)
    os.remove(d / "checkpoint")
    (d / "c.tmp.npz").write_bytes(b"PK\x03\x04 truncated")
    os.utime(d / "a.npz", (1, 1))
    os.utime(d / "c.tmp.npz", (2**31, 2**31))
    assert tck.latest_checkpoint(str(d)) == jck.latest_checkpoint(str(d)) == str(d / "b")
    os.utime(d / "b.index", (0, 0))
    assert tck.latest_checkpoint(str(d)) == jck.latest_checkpoint(str(d)) == str(d / "a.npz")
    (d / "checkpoint").write_text('model_checkpoint_path: "b"\n')
    assert tck.latest_checkpoint(str(d)) == jck.latest_checkpoint(str(d)) == str(d / "b")
    assert tck.latest_checkpoint(str(d / "a.npz")) == str(d / "a.npz")


def test_restrict_vars_and_object_graph_names(tmp_path, weights):
    """tf.train.Checkpoint names ('w_conv1/.ATTRIBUTES/VARIABLE_VALUE'):
    restrict_vars matches them by their flat name, normalize_names flattens
    them, and a flat name wins over its object-graph twin."""
    graph = {f"{k}/.ATTRIBUTES/VARIABLE_VALUE": v for k, v in weights.items()}
    graph["_CHECKPOINTABLE_OBJECT_GRAPH"] = np.zeros(3, np.uint8)
    graph["w_conv1"] = weights["w_conv1"] + 1
    prefix = str(tmp_path / "graph")
    jck.save_params_tf(prefix, graph)
    keep = {"w_conv1", "b_conv2"}
    got = tck.load_params(prefix, restrict_vars=keep)
    _assert_same_arrays(got, jck.load_params(prefix, restrict_vars=keep))
    assert len(got) == 3
    flat = tck.normalize_names(tck.load_params(prefix))
    _assert_same_arrays(flat, jck.normalize_names(jck.load_params(prefix)))
    assert sorted(flat) == sorted(set(weights) | {"_CHECKPOINTABLE_OBJECT_GRAPH"})


# ---- Orbax directories (tensorstore) -------------------------------------------


def _orbax_weights(weights):
    """The weights with a 0-d int32 among them (the scalars an Orbax tree
    holds as 0-d arrays)."""
    return {**weights, "global_step": np.array(1234, np.int32)}


def test_orbax_jax_to_port(tmp_path, weights):
    """A directory written by the JAX package's save_params_orbax (orbax)
    loads in the port through tensorstore bit for bit, each array with its
    own dtype and shape, 0-d included; restrict_vars keeps the names it
    holds (the JAX Orbax branch's rule)."""
    pytest.importorskip("tensorstore")
    params = _orbax_weights(weights)
    d = str(tmp_path / "orbax_ckpt")
    jck.save_params_orbax(d, params)
    _assert_same_arrays(tck.load_params_orbax(d), params)
    _assert_same_arrays(tck.load_params(d), jck.load_params(d))
    keep = {"w_conv1", "global_step", "absent"}
    got = tck.load_params(d, restrict_vars=keep)
    _assert_same_arrays(got, jck.load_params(d, restrict_vars=keep))
    assert sorted(got) == ["global_step", "w_conv1"]


def test_orbax_port_to_jax(tmp_path, weights):
    """A directory written by the port's save_params_orbax loads in the JAX
    package's load_params_orbax and load_params bit for bit.  A second save
    replaces it whole (orbax's force=True) and leaves no temporary
    sibling; the port refuses tensors as save_params does."""
    pytest.importorskip("tensorstore")
    params = _orbax_weights(weights)
    d = str(tmp_path / "orbax_ckpt")
    tck.save_params_orbax(d, {"stale": np.zeros(3, np.float32)})
    tck.save_params_orbax(d, params)
    assert os.listdir(tmp_path) == ["orbax_ckpt"]
    for load in (jck.load_params_orbax, jck.load_params, tck.load_params):
        _assert_same_arrays(load(d), params)
    with pytest.raises(TypeError, match="params_to_jax"):
        tck.save_params_orbax(d, {"w_conv1": torch.zeros(4, 1, 3, 3)})
    _assert_same_arrays(tck.load_params(d), params)


def test_orbax_nested_tree_refused(tmp_path, weights):
    """Only flat weight dicts load: a nested tree (key path longer than
    one) is a plain ValueError."""
    pytest.importorskip("tensorstore")
    import orbax.checkpoint as ocp

    d = str(tmp_path / "nested")
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(d, {"conv1": {"w": weights["w_conv1"]}})
    with pytest.raises(ValueError, match="nested tree"):
        tck.load_params(d)


def test_orbax_directory_refused(tmp_path, monkeypatch, weights):
    """Without tensorstore the three Orbax entry points raise
    NotImplementedError naming it and the .npz / TF-bundle way round."""
    import sys

    d = tmp_path / "orbax_ckpt"
    os.makedirs(d)
    (d / "_CHECKPOINT_METADATA").write_text("{}")
    monkeypatch.setitem(sys.modules, "tensorstore", None)  # import fails
    for call in (lambda: tck.load_params(str(d)),
                 lambda: tck.load_params_orbax(str(d)),
                 lambda: tck.save_params_orbax(str(tmp_path / "out"), weights)):
        with pytest.raises(NotImplementedError,
                           match="tensorstore package.*save_params.*save_params_tf"):
            call()
    assert not (tmp_path / "out").exists()


# ---- stream state ------------------------------------------------------------

LAYERS = "conv1=3,3,1,4 pool1=2,2 conv2=3,3,4,6 pool2=2,2 conv3=1,1,6,8"
MODES = ["dense", "sparse", "sparse_pallas", "sparse_rows", "window", "full"]


def _nets(rng, mode):
    defs = layers_dict(LAYERS)
    jp = {}
    for name, (kh, kw, ci, co) in ((n, s) for n, s in defs.items() if "conv" in n):
        jp[f"w_{name}"] = rng.randn(kh, kw, ci, co).astype(np.float32) * 0.3
        jp[f"b_{name}"] = rng.randn(co).astype(np.float32) * 0.1
    kw = dict(leak=0.01, alpha=0.1, padding="SAME", conv_mode=mode)
    jn = jnet.EventNetwork(defs, 16, 16, **kw)
    tn = tnet.EventNetwork(defs, 16, 16, **kw)
    return jn, {k: jnp.asarray(v) for k, v in jp.items()}, tn, params_from_jax(jp, "cpu")


def _chunks(rng, t, e=12, start=0):
    ts = (start + np.cumsum(rng.randint(1, 30, t * e))).astype(np.int32).reshape(t, e)
    arrays = (rng.randint(0, 16, (t, e)).astype(np.int32),
              rng.randint(0, 16, (t, e)).astype(np.int32), ts,
              np.zeros((t, e), np.int32), rng.rand(t, e) < 0.9)
    return (TChunk(*(torch.from_numpy(a) for a in arrays)),
            JChunk(*(jnp.asarray(a) for a in arrays)))


def _assert_same_leaves(got, want):
    g, w = tck._leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, i
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"leaf {i}")


@pytest.mark.parametrize("mode", MODES)
def test_stream_state_crosses_packages(tmp_path, rng, mode):
    """After a few steps in one package, its saved state restores into the
    other's init_state structure leaf for leaf bit for bit, in both
    directions; each package then runs on from the other's state to within
    1e-4 of running on from its own."""
    jn, jp, tn, tp = _nets(rng, mode)
    tc, jc = _chunks(rng, 2)
    tc2, jc2 = _chunks(rng, 2, start=int(tc.ts.max()))
    j_scan = jax.jit(jn.scan)  # one trace for the three calls
    j_state, _ = j_scan(jp, jn.init_state(jp), jc)
    t_state, _ = tn.scan(tp, tn.init_state(tp, "cpu"), tc)

    path_j, path_t = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jck.save_stream_state(path_j, j_state)
    tck.save_stream_state(path_t, t_state)
    from_jax = tck.restore_stream_state(path_j, tn.init_state(tp, "cpu"))
    from_torch = jck.restore_stream_state(path_t, jn.init_state(jp))
    _assert_same_leaves(from_jax, j_state)
    _assert_same_leaves(t_state, from_torch)
    assert type(from_jax) is tuple and [type(s) for s in from_jax] == [
        type(s) for s in t_state]

    _, want_t = tn.scan(tp, t_state, tc2)
    _, got_t = tn.scan(tp, from_jax, tc2)
    _, want_j = j_scan(jp, j_state, jc2)
    _, got_j = j_scan(jp, from_torch, jc2)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_j), atol=TOL, rtol=0)
    np.testing.assert_allclose(np.asarray(got_j), want_t.numpy(), atol=TOL, rtol=0)


def test_stream_state_round_trip_bit_for_bit(tmp_path, rng):
    """The port's own round trip continues bit for bit."""
    _, _, tn, tp = _nets(rng, "dense")
    tc, _ = _chunks(rng, 3)
    tc2, _ = _chunks(rng, 3, start=int(tc.ts.max()))
    state, _ = tn.scan(tp, tn.init_state(tp, "cpu"), tc)
    path = str(tmp_path / "state.ckpt")
    tck.save_stream_state(path, state)
    restored = tck.restore_stream_state(path, tn.init_state(tp, "cpu"))
    _, a = tn.scan(tp, state, tc2)
    _, b = tn.scan(tp, restored, tc2)
    np.testing.assert_array_equal(_bits(a.numpy()), _bits(b.numpy()))
    with pytest.raises(ValueError, match="leaves"):
        tck.restore_stream_state(path, tn.init_state(tp, "cpu")[:-1])


def test_stream_state_dtype_refusals(tmp_path):
    """Nothing is cast.  An int64 leaf (torch.tensor(0)'s dtype) where the
    structure holds int32 is refused by both packages; so is a float64
    one; a shape mismatch too.  A bfloat16 leaf is written as the JAX
    package writes it (2-byte voids) and refused on restore by both."""
    like = (torch.zeros((2, 2)), torch.zeros((), dtype=torch.int32))
    like_j = (jnp.zeros((2, 2)), jnp.int32(0))
    leak = str(tmp_path / "int64.npz")
    tck.save_stream_state(leak, (torch.ones((2, 2)), torch.tensor(7)))
    for restore, structure in ((tck.restore_stream_state, like),
                               (jck.restore_stream_state, like_j)):
        with pytest.raises(ValueError, match="dtype int64"):
            restore(leak, structure)
    f64 = str(tmp_path / "f64.npz")
    jck.save_stream_state(f64, (np.zeros((2, 2)), np.int32(0)))
    with pytest.raises(ValueError, match="dtype float64"):
        tck.restore_stream_state(f64, like)
    with pytest.raises(ValueError, match="shape"):
        tck.restore_stream_state(f64, (torch.zeros((2, 3)), like[1]))

    vals = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    bf_t, bf_j = str(tmp_path / "bf_t.npz"), str(tmp_path / "bf_j.npz")
    tck.save_stream_state(bf_t, (torch.from_numpy(vals).bfloat16(),))
    jck.save_stream_state(bf_j, (jnp.asarray(vals, jnp.bfloat16),))
    with np.load(bf_t) as zt, np.load(bf_j) as zj:
        assert zt["leaf_0"].dtype == zj["leaf_0"].dtype == np.dtype("V2")
        assert zt["leaf_0"].tobytes() == zj["leaf_0"].tobytes()
    for path in (bf_t, bf_j):
        with pytest.raises(ValueError, match="dtype"):
            tck.restore_stream_state(path, (torch.zeros((2, 3), dtype=torch.bfloat16),))
        with pytest.raises(ValueError, match="dtype"):
            jck.restore_stream_state(path, (jnp.zeros((2, 3), jnp.bfloat16),))


# ---- YoloEventTorch(checkpoint=...) --------------------------------------------


def _model_kwargs():
    return dict(h_frame=16, w_frame=16, num_classes=3, cnn_layers=layers_dict(LAYERS),
                cnn_padding="SAME", h_cells=4, w_cells=4, num_bbox=1, alpha=0.1,
                leak=0.01, conv_mode="full")


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("fmt", ["npz", "bundle", "directory", "orbax"])
def test_yolo_event_torch_from_checkpoint(tmp_path, rng, writer, fmt):
    """A model built from a checkpoint of either package holds the same
    tensors as one given the arrays by set_weights (the same as one loaded
    from .npz), and scans the same grids bit for bit."""
    _, jp, _, _ = _nets(rng, "full")
    weights = {k: np.asarray(v) for k, v in jp.items()}
    ck = PACKAGES[writer]
    if fmt == "npz":
        path = str(tmp_path / "w.npz")
        ck.save_params(path, weights)
    elif fmt == "orbax":
        pytest.importorskip("tensorstore")
        path = str(tmp_path / "orbax_ckpt")
        ck.save_params_orbax(path, weights)
    else:
        path = str(tmp_path / "w")
        ck.save_params_tf(path, weights)
        if fmt == "directory":
            path = str(tmp_path)
    ref = YoloEventTorch(**_model_kwargs(), device="cpu")
    ref.set_weights(weights)
    model = YoloEventTorch(**_model_kwargs(), checkpoint=path, device="cpu")
    assert sorted(model.params) == sorted(ref.params)
    for k in ref.params:
        assert model.params[k].dtype == ref.params[k].dtype
        np.testing.assert_array_equal(_bits(model.params[k].numpy()),
                                      _bits(ref.params[k].numpy()))
    tc, jc = _chunks(rng, 4)
    _, a = model.scan(model.init_state(), tc)
    _, b = ref.scan(ref.init_state(), tc)
    np.testing.assert_array_equal(_bits(a.numpy()), _bits(b.numpy()))
    # and the JAX model from the same checkpoint scans the same grids
    jm = YoloEventJax(**_model_kwargs(), checkpoint=path)
    _, want = jm.scan(jm.init_state(), jc)
    np.testing.assert_allclose(a.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_yolo_restore_restrict_vars(tmp_path, rng):
    _, jp, _, _ = _nets(rng, "full")
    weights = {k: np.asarray(v) for k, v in jp.items()}
    path = str(tmp_path / "w.npz")
    tck.save_params(path, weights)
    model = YoloEventTorch(**_model_kwargs(), device="cpu")
    model.restore(path, restrict_vars={"w_conv1", "b_conv1"})
    assert sorted(model.params) == ["b_conv1", "w_conv1"]
    model.restore(path)
    assert sorted(model.params) == sorted(weights)
