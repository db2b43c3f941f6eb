"""The port's integration front half (async_ev_cnn_torch/ops/integrate.py)
and the plain versions of its two surface-scan kernels
(async_ev_cnn_torch/ops/surface_scan.py) held against the JAX package.

Tolerance: none — every comparison is bit for bit (``array_equal`` on the
float32 bit patterns, so -0.0 and +0.0 differ), as the JAX package's own
kernel tests hold its Pallas kernels.  The JAX kernels run in interpret
mode on the CPU, as tests/test_pallas_scan.py runs them.  The CUDA kernels
themselves run only on the card, where chip_smoke.py holds them against
these plain versions.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from async_ev_cnn_torch.layers.types import EventChunk as TChunk
from async_ev_cnn_torch.ops import integrate as tint
from async_ev_cnn_torch.ops import surface_scan as tscan
from async_ev_cnn_tpu.layers.types import EventChunk as JChunk
from async_ev_cnn_tpu.ops import integrate as jint
from async_ev_cnn_tpu.ops.pallas_scan import surface_scan_events_pallas, surface_scan_pallas

torch.set_num_threads(2)


def _chunk_arrays(rng, t, e, h, w, occupancy=0.8):
    ts = np.cumsum(rng.randint(1, 40, t * e)).astype(np.int32).reshape(t, e)
    y = rng.randint(0, h, (t, e)).astype(np.int32)
    x = rng.randint(0, w, (t, e)).astype(np.int32)
    p = rng.randint(0, 2, (t, e)).astype(np.int32)
    valid = rng.rand(t, e) < occupancy
    return y, x, ts, p, valid


def _both(arrays):
    return (TChunk(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)),
            JChunk(*(jnp.asarray(a) for a in arrays)))


def _surface(rng, c, h, w):
    return (np.round(rng.rand(c, h, w) * 2**20) / 2**20).astype(np.float32)


def _assert_bits(got, want):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want)


def _step_cases(rng):
    h, w = 9, 11
    y, x, ts, p, valid = (a[0] for a in _chunk_arrays(rng, 1, 24, h, w))
    yield "random", (y, x, ts, p, valid), 2e-3, 5
    # every event on two pixels, with ts ties: the last duplicate wins
    yd = np.array([3, 3, 3, 3, 1, 1, 3, 1], np.int32)
    xd = np.array([4, 4, 4, 4, 2, 2, 4, 2], np.int32)
    tsd = np.array([7, 9, 9, 9, 9, 12, 12, 12], np.int32)
    pd = np.array([0, 1, 0, 1, 1, 0, 0, 1], np.int32)
    yield "duplicates", (yd, xd, tsd, pd, np.ones(8, bool)), 2e-3, 0
    yield "empty", (y, x, ts, p, np.zeros_like(valid)), 2e-3, 40
    # dt = last_ts - ts up to ~2^31: the int->float conversion rounds
    tsl = np.array([0, 255, 2**24 + 5, 2**31 - 20], np.int32)
    yield "dt_near_2^31", (y[:4], x[:4], tsl, p[:4], np.ones(4, bool)), 1e-9, 0


@pytest.mark.parametrize("channels", [1, 2])
def test_integrate_step_bit_exact(rng, channels):
    for name, (y, x, ts, p, valid), leak, prev in _step_cases(rng):
        s0 = _surface(rng, channels, 9, 11)
        s0[0, 0, :2] = 0.0
        if channels == 1:
            s0 = s0[0]
        pt = p if channels == 2 else None
        got = tint.integrate_step(torch.from_numpy(s0), prev, *(
            torch.from_numpy(a) for a in (y, x, ts, valid)), leak,
            p=None if pt is None else torch.from_numpy(pt))
        want = jint.integrate_step(jnp.asarray(s0), jnp.int32(prev), *(
            jnp.asarray(a) for a in (y, x, ts, valid)), leak,
            p=None if pt is None else jnp.asarray(pt))
        for g, wv in zip(got, want):
            _assert_bits(g, wv)


def test_integrate_step_needs_polarity_for_channels():
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="polarity"):
        tint.integrate_step(torch.zeros(2, 3, 3), 0, z, z, z, z > 0, 1e-3)


@pytest.mark.parametrize("channels", [1, 2])
def test_chain_and_event_updates_match(rng, channels):
    """_ts_chain exactly; the winner lists: the port's flat index equals
    the JAX package's pix_r * 128 + pix_c (the TPU kernel's lane split),
    losers are -1 in both forms, dt equal."""
    h, w = 13, 17
    arrays = _chunk_arrays(rng, 10, 12, h, w)
    arrays[3][2] = arrays[3][1]  # duplicate pixel with a ts tie in chunk 2
    arrays[4][4] = False  # an all-padding chunk
    tc, jc = _both(arrays)
    lt_t, d_t = tint._ts_chain(7, tc, 3e-3)
    lt_j, d_j = jint._ts_chain(jnp.int32(7), jc, 3e-3)
    _assert_bits(lt_t, lt_j)
    _assert_bits(d_t, d_j)

    pix, dt, d, lt = tint.chunk_event_updates(channels, h, w, 7, tc, 3e-3)
    pr, pc, dtj, dj, ltj = jint.chunk_event_updates(channels, h, w, jnp.int32(7), jc, 3e-3)
    pr, pc = np.asarray(pr), np.asarray(pc)
    np.testing.assert_array_equal(pix.numpy(), np.where(pr >= 0, pr * 128 + pc, -1))
    _assert_bits(dt, dtj)
    _assert_bits(d, dj)
    _assert_bits(lt, ltj)
    assert (pix.numpy() >= 0).sum() > 0

    ts_map, d2, lt2 = tint.chunk_ts_maps(channels, h, w, 7, tc, 3e-3)
    ts_mj, d2j, lt2j = jint.chunk_ts_maps(channels, h, w, jnp.int32(7), jc, 3e-3)
    _assert_bits(ts_map, ts_mj)
    _assert_bits(d2, d2j)
    _assert_bits(lt2, lt2j)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("shape", [(13, 17), (16, 16)])
def test_plain_scans_bit_exact_vs_pallas(rng, channels, shape):
    """Both plain versions against the JAX Pallas kernels (interpret mode)
    on the same winner lists and ts maps, at the sizes of
    tests/test_pallas_scan.py: unaligned shapes, T=10, E=12, 1 or 2
    channels (CHW flattening)."""
    h, w = shape
    leak = 3e-3
    arrays = _chunk_arrays(rng, 10, 12, h, w)
    arrays[4][0, 0] = True
    tc, jc = _both(arrays)
    s0 = _surface(rng, channels, h, w)

    pr, pc, dtj, dj, ltj = jint.chunk_event_updates(channels, h, w, jnp.int32(5), jc, leak)
    want_e = surface_scan_events_pallas(jnp.asarray(s0), pr, pc, dtj, dj, leak,
                                        interpret=True)
    pix, dt, d, _ = tint.chunk_event_updates(channels, h, w, 5, tc, leak)
    _assert_bits(tscan.surface_scan_events(torch.from_numpy(s0), pix, dt, d, leak), want_e)

    ts_mj, d2j, lt2j = jint.chunk_ts_maps(channels, h, w, jnp.int32(5), jc, leak)
    want_t = surface_scan_pallas(jnp.asarray(s0), ts_mj, d2j, lt2j, leak, interpret=True)
    ts_map, d2, lt2 = tint.chunk_ts_maps(channels, h, w, 5, tc, leak)
    _assert_bits(tscan.surface_scan_tsmap(torch.from_numpy(s0), ts_map, d2, lt2, leak),
                 want_t)
    # both engines agree with each other too
    _assert_bits(want_e, want_t)


@pytest.mark.parametrize("t,p", [(1, 1), (10, 442), (64, 128), (66, 300), (200, 35840),
                                 (129, 71680)])
def test_scan_events_plan_tiles_and_windows(t, p):
    """K1's plan: every pixel in exactly one tile (the last one ragged and
    never empty), the windows partition T, and the workspace holds the
    binned entries and the bucket offsets."""
    plan = tscan.scan_events_plan(t, 12, p)
    cover = np.zeros(p, np.int32)
    for j in range(plan.n_tiles):
        cover[j * plan.tile:(j + 1) * plan.tile] += 1
    assert (cover == 1).all() and (plan.n_tiles - 1) * plan.tile < p
    runs = [(w * plan.window, min((w + 1) * plan.window, t)) for w in range(plan.n_windows)]
    assert runs[0][0] == 0 and runs[-1][1] == t and all(a < b for a, b in runs)
    assert all(runs[i][1] == runs[i + 1][0] for i in range(len(runs) - 1))
    assert plan.bin_smem_bytes == 4 * (plan.n_tiles + 1) <= tscan.SMEM_LIMIT_BYTES
    assert plan.workspace == 2 * t * 12 + t * (plan.n_tiles + 1)


def test_scan_events_plan_matches_the_cuda_source():
    """The plan's tile and window are the kernel's: surface_scan.cu refuses
    a launch whose tile, window, tile count or binning shared memory
    disagrees with its own."""
    src = (Path(__file__).resolve().parent.parent / "async_ev_cnn_torch" / "csrc"
           / "surface_scan.cu").read_text()
    for name, value in (("kTile", tscan.SCAN_TILE), ("kWindow", tscan.SCAN_WINDOW)):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found is not None and int(found.group(1)) == value, name
    assert "__shared__ float contrib[kWindow][kTile];" in src
    plan = tscan.scan_events_plan(200, 256, 160 * 224)
    assert (plan.n_tiles, plan.n_windows) == (280, 4)
    with pytest.raises(ValueError, match="shared memory"):
        tscan.scan_events_plan(2, 4, 128 * 60_000)


def test_plain_scan_matches_pallas_across_windows_and_ragged_tiles(rng):
    """The events scan's plain version against the JAX Pallas kernel
    (interpret mode) at T = 66 (two windows, the second ragged), 2
    channels of 13x17 (P = 442, the last tile ragged), with winners
    replaced by -1 and by P (out of range: no event in either)."""
    h, w, t, channels, leak = 13, 17, 66, 2, 3e-3
    p = channels * h * w
    assert t % tscan.SCAN_WINDOW and p % tscan.SCAN_TILE
    arrays = _chunk_arrays(rng, t, 12, h, w)
    tc, jc = _both(arrays)
    s0 = _surface(rng, channels, h, w)
    pix, dt, d, _ = tint.chunk_event_updates(channels, h, w, 5, tc, leak)
    pix = pix.clone()
    pix[::3, 0] = -1
    pix[1::3, 1] = p
    pix_np = pix.numpy()
    assert (pix_np == p).any() and (pix_np >= 0).sum() > t
    pr = np.where(pix_np >= 0, pix_np // 128, -1).astype(np.int32)
    pc = np.where(pix_np >= 0, pix_np % 128, 0).astype(np.int32)
    want = surface_scan_events_pallas(jnp.asarray(s0), jnp.asarray(pr), jnp.asarray(pc),
                                      jnp.asarray(dt.numpy()), jnp.asarray(d.numpy()), leak,
                                      interpret=True)
    _assert_bits(tscan.surface_scan_events(torch.from_numpy(s0), pix, dt, d, leak), want)
    # and against the ts-map engine where no winner was replaced
    pix2, dt2, d2, _ = tint.chunk_event_updates(channels, h, w, 5, tc, leak)
    ts_map, d3, lt3 = tint.chunk_ts_maps(channels, h, w, 5, tc, leak)
    _assert_bits(tscan.surface_scan_events_plain(torch.from_numpy(s0), pix2, dt2, d2, leak),
                 tscan.surface_scan_tsmap_plain(torch.from_numpy(s0), ts_map, d3, lt3, leak)
                 .numpy())


@pytest.mark.parametrize("t,p", [(1, 1), (10, 442), (32, 32), (33, 63), (70, 300),
                                 (200, 35840), (129, 71680)])
def test_scan_tsmap_plan_tiles_and_windows(t, p):
    """K2's plan: every pixel in exactly one tile (the last one ragged and
    never empty), and the windows partition T (the last one ragged)."""
    plan = tscan.scan_tsmap_plan(t, p)
    cover = np.zeros(p, np.int32)
    for j in range(plan.n_tiles):
        cover[j * plan.tile:(j + 1) * plan.tile] += 1
    assert (cover == 1).all() and (plan.n_tiles - 1) * plan.tile < p
    chunks = np.zeros(t, np.int32)
    for w in range(plan.n_windows):
        chunks[w * plan.window:(w + 1) * plan.window] += 1
    assert (chunks == 1).all() and (plan.n_windows - 1) * plan.window < t


def test_scan_tsmap_plan_matches_the_cuda_source():
    """The plan's tile and window are the kernel's: surface_scan.cu refuses
    a launch whose tile, window or tile count disagrees with its own, and
    its kernel is one warp a block with a lane a chunk's scalars."""
    src = (Path(__file__).resolve().parent.parent / "async_ev_cnn_torch" / "csrc"
           / "surface_scan.cu").read_text()
    for name, value in (("kTsTile", tscan.TSMAP_TILE), ("kTsWindow", tscan.TSMAP_WINDOW)):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found is not None and int(found.group(1)) == value, name
    assert "n_tiles != (p_len + kTsTile - 1) / kTsTile" in src
    assert tscan.TSMAP_TILE == tscan.TSMAP_WINDOW == 32
    plan = tscan.scan_tsmap_plan(200, 160 * 224)
    assert (plan.n_tiles, plan.n_windows) == (1120, 7)


@pytest.mark.parametrize("t,channels,h,w", [(33, 1, 7, 9), (70, 2, 13, 17)])
def test_plain_tsmap_scan_matches_pallas_across_windows_and_ragged_tiles(rng, t, channels,
                                                                         h, w):
    """The ts-map scan's plain version against the JAX Pallas kernel
    (interpret mode) at T past one of K2's windows and not a multiple of
    it (33: the second window one chunk; 70: three windows) and P not a
    multiple of its tile (63, 442), with one all-padding chunk."""
    leak = 3e-3
    assert t % tscan.TSMAP_WINDOW and (channels * h * w) % tscan.TSMAP_TILE
    arrays = _chunk_arrays(rng, t, 12, h, w)
    arrays[4][t // 2] = False
    tc, jc = _both(arrays)
    s0 = _surface(rng, channels, h, w)
    ts_mj, d2j, lt2j = jint.chunk_ts_maps(channels, h, w, jnp.int32(5), jc, leak)
    want = surface_scan_pallas(jnp.asarray(s0), ts_mj, d2j, lt2j, leak, interpret=True)
    ts_map, d2, lt2 = tint.chunk_ts_maps(channels, h, w, 5, tc, leak)
    _assert_bits(tscan.surface_scan_tsmap(torch.from_numpy(s0), ts_map, d2, lt2, leak), want)


def test_integrate_parallel_engines_match_sequential_chain(rng):
    """integrate_parallel ('events', 'tsmap', 'auto') against the port's own
    iterated integrate_step, on a 2-channel surface with an empty chunk."""
    h, w = 8, 12
    arrays = _chunk_arrays(rng, 7, 10, h, w)
    arrays[4][5] = False
    tc, _ = _both(arrays)
    s0 = torch.from_numpy(_surface(rng, 2, h, w))
    s, pts, ref = s0, torch.tensor(3, dtype=torch.int32), []
    for i in range(7):
        s, pts, _, _ = tint.integrate_step(s, pts, tc.y[i], tc.x[i], tc.ts[i],
                                           tc.valid[i], 2e-3, p=tc.p[i])
        ref.append(s)
    ref = torch.stack(ref)
    for engine in ("auto", "events", "tsmap"):
        surfaces, last_ts = tint.integrate_parallel(s0, 3, tc, 2e-3, engine=engine)
        _assert_bits(surfaces, ref.numpy())
        assert int(last_ts[-1]) == int(pts)
    with pytest.raises(ValueError, match="engine"):
        tint.integrate_parallel(s0, 3, tc, 2e-3, engine="xla")


def test_plain_scans_identity_on_empty_chunks(rng):
    """All-padding chunks: d = 0 and no winner, so every surface equals the
    incoming one bit for bit (scan_parallel relies on it)."""
    h, w, t, e = 8, 16, 5, 6
    arrays = [np.zeros((t, e), np.int32)] * 4 + [np.zeros((t, e), bool)]
    tc, _ = _both(arrays)
    s0 = torch.from_numpy(_surface(rng, 1, h, w))
    for engine in ("events", "tsmap"):
        s, lt = tint.integrate_parallel(s0, 42, tc, 1e-3, engine=engine)
        _assert_bits(s, np.broadcast_to(s0.numpy(), (t, 1, h, w)))
        np.testing.assert_array_equal(lt.numpy(), np.full(t, 42, np.int32))


def test_wrappers_refuse_mixed_devices_and_missing_nvcc(tmp_path, monkeypatch):
    """A wrapper runs the plain version only when every tensor lies on the
    CPU; anything else must launch the kernel or raise — and without nvcc
    the build raises instead of falling back."""
    from async_ev_cnn_torch.ops import cuda_build

    z = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="all lie on the CPU or all on the card"):
        tscan.surface_scan_events(torch.zeros(1, 2, 2, device="meta"), z, z,
                                  torch.zeros(2), 1e-3)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.load("surface_scan")
    # the library name follows the source and the flags
    assert cuda_build.library_path("surface_scan") == cuda_build.library_path("surface_scan")
    assert cuda_build.library_path("surface_scan").name.startswith("surface_scan_")
