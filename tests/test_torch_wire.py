"""The port's wire tiers (async_ev_cnn_torch/utils/wire.py) held against the
JAX package's (async_ev_cnn_tpu/utils/wire.py) on the same seeded events.

Tolerance: none.  The packers, the tier classifier and the host
re-encoders are copied, so their arrays are byte-equal; every device
unpack is integer arithmetic, so its planes are equal to the JAX unpack's,
padding lanes included, and equal to packing the raw events directly.
The tier gates are fuzzed with hypothesis (derandomized, no example
database): whatever the gates accept or refuse, both packages agree.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from async_ev_cnn_torch.utils import wire as tw
from async_ev_cnn_torch.utils.runner import pack_chunks as t_pack_chunks
from async_ev_cnn_tpu.utils import wire as jw

torch.set_num_threads(2)

PACKERS = ("pack_wire_ultra4", "pack_wire_ultra", "pack_wire_compact", "pack_wire")
UNPACKERS = {"ultra4": "chunks_from_wire_ultra4", "ultra": "chunks_from_wire_ultra",
             "compact": "chunks_from_wire_compact", "plain": "chunks_from_wire"}
FIELDS = ("y", "x", "ts", "p", "valid")


def _events(rng, n, gap, coord=256, polarity=False, monotone=True):
    ts = np.cumsum(rng.randint(0, gap, n)).astype(np.int64)
    if not monotone and n > 2:
        rng.shuffle(ts)
    cols = [rng.randint(0, coord, n), rng.randint(0, coord, n), ts]
    if polarity:
        cols.append(rng.randint(0, 2, n))
    return np.stack(cols, axis=-1).astype(np.int64).reshape(n, len(cols))


def _t_unpack(w, polarity):
    """The port's device unpack of a host wire tuple (CPU tensors)."""
    planes = tw.wire_to_device(w, "cpu")
    if len(w) == 3:
        return tw.chunks_from_wire(*planes, polarity=polarity)
    return getattr(tw, UNPACKERS[tw.wire_format(w)])(*planes)


def _j_unpack(w, polarity):
    if len(w) == 3:
        return jw.chunks_from_wire(*w, polarity=polarity)
    return getattr(jw, UNPACKERS[jw.wire_format(w)])(*w)


def _assert_chunks_equal(got, want):
    for f in FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("polarity", [False, True])
@pytest.mark.parametrize("n,cap,gap", [(0, 16, 3), (1, 8, 3), (37, 33, 15), (500, 64, 15),
                                       (300, 32, 200), (256, 256, 4000), (97, 31, 90000)])
def test_packers_byte_equal_and_unpacks_equal(rng, polarity, n, cap, gap):
    """Every packer's arrays byte-equal to JAX's (or both refuse); every
    accepted tier unpacked on the port's side equal to the JAX unpack and
    to pack_chunks of the raw events."""
    ev = _events(rng, n, gap, polarity=polarity)
    direct = t_pack_chunks(ev if polarity else ev[:, :3], cap, device="cpu")
    accepted = []
    for name in PACKERS:
        got = getattr(tw, name)(ev, cap, keep_polarity=polarity)
        want = getattr(jw, name)(ev, cap, keep_polarity=polarity)
        assert (got is None) == (want is None), name
        if got is None:
            continue
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes(), name
        assert tw.wire_format(got) == jw.wire_format(want)
        chunk = _t_unpack(got, polarity)
        _assert_chunks_equal(chunk, _j_unpack(want, polarity))
        valid = direct.valid.numpy()
        np.testing.assert_array_equal(chunk.valid.numpy(), valid)
        for f in ("y", "x", "ts") + (("p",) if polarity else ()):
            np.testing.assert_array_equal(getattr(chunk, f).numpy()[valid],
                                          getattr(direct, f).numpy()[valid])
        accepted.append(tw.wire_format(got))
    assert "plain" in accepted
    if gap <= 16:
        assert accepted[0] == "ultra4"


@pytest.mark.parametrize("polarity", [False, True])
def test_stacked_streams_unpack_in_one_call(rng, polarity):
    """A stacked [S, ...] group (the pipeline's multi-stream wire) decodes
    in one call, equal stream by stream to the JAX unpack and to the port's
    own unpack of each stream alone."""
    cap, t = 32, 3
    for name in PACKERS:
        ws = [getattr(tw, name)(_events(rng, t * cap - 5 * i, 12, polarity=polarity), cap,
                                keep_polarity=polarity) for i in range(3)]
        ws = [tw.wire_to_tier(w, tw.wire_format(ws[0])) for w in ws]
        stacked = tuple(np.stack(parts) for parts in zip(*ws))
        got = tw.chunks_from_wire_any(tw.wire_to_device(stacked, "cpu"), polarity)
        want = _j_unpack(stacked, polarity)
        _assert_chunks_equal(got, want)
        for i, w in enumerate(ws):
            one = _t_unpack(w, polarity)
            for f in FIELDS:
                np.testing.assert_array_equal(getattr(got, f)[i].numpy(),
                                              getattr(one, f).numpy())


@pytest.mark.parametrize("polarity", [False, True])
def test_tier_ladder_and_reencoders_match_jax(rng, polarity):
    """wire_to_tier up the whole ladder, and each host re-encoder, equal to
    the JAX package's byte for byte; each rung decodes to the same chunks."""
    assert tw.WIRE_TIERS == jw.WIRE_TIERS
    for n, cap in ((500, 64), (37, 33), (0, 16)):
        ev = _events(rng, n, 16, polarity=polarity)
        base = tw.pack_wire_ultra4(ev, cap, keep_polarity=polarity)
        assert base is not None and tw.wire_format(base) == "ultra4"
        first = _t_unpack(base, polarity)
        for tier in tw.WIRE_TIERS:
            got, want = tw.wire_to_tier(base, tier), jw.wire_to_tier(base, tier)
            assert tw.wire_format(got) == jw.wire_format(want) == tier
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
            _assert_chunks_equal(_t_unpack(got, polarity), first)
        for conv, arg in (("wire_ultra4_to_ultra", base),
                          ("wire_ultra_to_compact", tw.wire_ultra4_to_ultra(base)),
                          ("wire_compact_to_plain", tw.wire_to_tier(base, "compact"))):
            for a, b in zip(getattr(tw, conv)(arg), getattr(jw, conv)(arg)):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert tw.wire_to_tier(base, "ultra4") is base


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(n=st.integers(0, 300), cap=st.sampled_from([2, 3, 8, 31, 64, 256]),
       gap=st.sampled_from([1, 16, 17, 256, 257, 2**16 // 8, 2**16, 300_000]),
       coord=st.sampled_from([200, 256, 257, 2**15]), polarity=st.booleans(),
       monotone=st.booleans(), seed=st.integers(0, 2**16))
def test_tier_gates_fuzz(n, cap, gap, coord, polarity, monotone, seed):
    """Streams drawn across every tier's gate (gaps at 16 and 256 µs, spans
    at 2**16 µs, coordinates at 256, out-of-order timestamps, odd and tiny
    capacities): each packer accepts or refuses as JAX's does, byte-equal
    when it accepts, and what it packs decodes to the JAX decode."""
    rng = np.random.RandomState(seed)
    ev = _events(rng, n, gap, coord=coord, polarity=polarity, monotone=monotone)
    if n and ev[:, 2].max() >= 2**31:
        return  # outside the int32 contract every tier enforces
    for name in PACKERS:
        try:
            got = getattr(tw, name)(ev, cap, keep_polarity=polarity)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:20]):
                getattr(jw, name)(ev, cap, keep_polarity=polarity)
            continue
        want = getattr(jw, name)(ev, cap, keep_polarity=polarity)
        assert (got is None) == (want is None), name
        if got is not None:
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
            _assert_chunks_equal(_t_unpack(got, polarity), _j_unpack(want, polarity))


def test_packers_refuse_what_jax_refuses(rng):
    """Negative and past-int32 timestamps, bad polarity: the same errors."""
    for bad_ts in (-1, 2**31):
        ev = _events(rng, 8, 3)
        ev[3, 2] = bad_ts
        for name in PACKERS:
            with pytest.raises(ValueError):
                getattr(tw, name)(ev, 8)
    ev = _events(rng, 8, 3, polarity=True)
    ev[0, 3] = 2
    for name in PACKERS:
        with pytest.raises(ValueError, match="polarity must be 0/1"):
            getattr(tw, name)(ev, 8, keep_polarity=True)
    with pytest.raises(ValueError, match="4th"):
        tw.pack_wire_compact(_events(rng, 8, 3), 8, keep_polarity=True)
    assert tw.pack_wire_ultra4(_events(rng, 8, 3), 1) is None


@pytest.mark.parametrize("polarity", [False, True])
@pytest.mark.parametrize("packer", PACKERS)
def test_wire_to_device_fills_given_planes_in_place(rng, packer, polarity):
    """A captured graph's input planes: an upload into the planes of an
    earlier one fills those tensors, in place, with what a fresh upload
    gives (dtypes included, a u16 plane as its int16 view)."""
    first = getattr(tw, packer)(_events(rng, 150, 3, polarity=polarity), 64,
                                keep_polarity=polarity)
    planes = tw.wire_to_device(first, "cpu")
    for _ in range(2):  # the same planes filled twice, as a replay's inputs are
        w = getattr(tw, packer)(_events(rng, 150, 3, polarity=polarity), 64,
                                keep_polarity=polarity)
        got = tw.wire_to_device(w, "cpu", out=planes)
        assert all(g is p for g, p in zip(got, planes))
        for g, want in zip(got, tw.wire_to_device(w, "cpu")):
            assert g.dtype == want.dtype and torch.equal(g, want)
        _assert_chunks_equal(tw.chunks_from_wire_any(planes, polarity), _t_unpack(w, polarity))
