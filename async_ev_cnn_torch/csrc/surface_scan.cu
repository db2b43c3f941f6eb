// Leaky-surface scan kernels for Hopper (sm_90a).
//
// Both scans (K1 and K2) produce all T chunk-boundary surfaces of the
// integration layer in one pass: per pixel, per chunk t,
//
//     s1 = s - d[t];  s1 = s1 <= 0 ? 0 : s1          (leak, clamp)
//     s  = s1 + a[t]; s  = s  <= 0 ? 0 : s           (event, clamp)
//     out[t] = s
//
// with a[t] = 1 - snap(dt * leak) at a pixel that has an event in chunk t
// and 0 elsewhere: the exact arithmetic of ops/integrate.integrate_step,
// bit for bit.  What keeps it bit-exact:
//   * snap(x) = rint(x * 2^20) * 2^-20, rounding half to EVEN (rintf);
//     roundf would round half away from zero.
//   * every product and sum is an explicit __fmul_rn / __fadd_rn /
//     __fsub_rn, and the file is built with --fmad=false, so no
//     multiply-add is contracted into an FMA;
//   * leak arrives as a float32 and dt is converted with __int2float_rn
//     (round to nearest, as astype(float32) does);
//   * the clamps are selects, not fmaxf, so zeros keep the reference sign.
//
// Both scans keep one pixel's running surface in a register of one thread
// across the whole T loop: pixels are independent, time is sequential.
// They are bound by device-memory bytes: the T*P*4 bytes of surfaces they
// must write (and, for the ts-map kernel, the same again of ts maps read);
// the arithmetic is a handful of float ops per pixel and chunk.  Each
// thread reads and writes its pixel at consecutive addresses across a warp
// (coalesced), and no chunk's output is written twice.
//
// Built by async_ev_cnn_torch/ops/cuda_build.py; bound with ctypes by
// async_ev_cnn_torch/ops/surface_scan.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTsTile = 32;      // scan_tsmap_kernel: pixels per tile (block), one per thread
constexpr int kTsWindow = 32;    // scan_tsmap_kernel: chunks prefetched per window
constexpr int kTile = 128;       // scan_events_kernel: pixels per tile (block), one per thread
constexpr int kWindow = 64;      // scan_events_kernel: chunks per window
constexpr int kBinThreads = 256; // bin_events_kernel: threads per chunk
constexpr float kSnapUp = 1048576.0f;            // 2^20 (SNAP_BITS)
constexpr float kSnapDown = 1.0f / 1048576.0f;   // 2^-20, exact
constexpr int32_t kTsSentinel = -2147483647;     // -(2^31) + 1: no event

static_assert(kWindow == 64 && kTile >= 64,
              "warp 0 reads two chunks' buckets a lane, warp 1 two decrements");

__device__ __forceinline__ float snap(float x) {
  return __fmul_rn(rintf(__fmul_rn(x, kSnapUp)), kSnapDown);
}

__device__ __forceinline__ float clamp0(float s) { return s <= 0.0f ? 0.0f : s; }

__device__ __forceinline__ float contribution(int32_t dt, float leak) {
  return __fsub_rn(1.0f, snap(__fmul_rn(__int2float_rn(dt), leak)));
}

__device__ __forceinline__ int warp_inclusive_sum(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// K1 replaces async_ev_cnn_tpu/ops/pallas_scan.py::surface_scan_events_pallas
// (_scan_events_kernel).  The TPU kernel has no scatter, so it places each
// chunk's winners by a bf16 one-hot matrix product with 8-bit dt limbs.
// Here two kernels, launched back to back by one call:
//
//   1. bin_events_kernel, one block per chunk t, sorts the chunk's winners
//      by pixel tile (kTile pixels): a shared-memory histogram, a block
//      scan to bucket starts, written as offsets[t][0..n_tiles], and each
//      winner written to its bucket as (pixel within the tile, its
//      contribution 1 - snap(dt * leak)).  Slots within a bucket come from
//      shared-memory atomics, so their order varies between launches, but
//      after the dedup of ops/integrate.chunk_event_updates a pixel has at
//      most one winner a chunk: each contribution lands in one place
//      whatever the order, and the output is bit-exact.
//   2. scan_events_kernel, one block per tile, walks T in windows of
//      kWindow chunks.  Per window, warp 0 reads the tile's bucket of each
//      chunk (two chunks a lane) and scans their lengths; after one
//      barrier the block scatters the window's events into a shared
//      [kWindow, kTile] contribution array (each event a flat position
//      across the window's buckets, found by binary search, so a hot tile
//      spreads its events over all threads); after a second barrier each
//      thread walks its pixel through the window from shared memory and
//      registers alone, clearing its column as it goes.
//
// Against the earlier design (one block per 128 pixels re-reading every
// chunk's whole winner list from L2 between three barriers a chunk, 280 x
// 410 KB of L2 reads a T=200 call), a block reads only its own winners and
// meets two barriers a window.  Bound: the T*P*4 bytes of surfaces written,
// plus the P*4 B surface, the T*E*8 B of winner lists and the T*4 B of
// decrements read once; the binned lists (T*E*8 B) and offsets (T*(n_tiles
// + 1)*4 B) are written and read once more.

__global__ void __launch_bounds__(kBinThreads)
bin_events_kernel(const int32_t* __restrict__ pix, const int32_t* __restrict__ dt,
                  int2* __restrict__ entries, int32_t* __restrict__ offsets, int e_len,
                  int p_len, int n_tiles, float leak) {
  extern __shared__ int32_t bucket[];  // [n_tiles + 1]: counts, then starts
  __shared__ int32_t warp_total[kBinThreads / 32];
  const int n = n_tiles + 1;
  const size_t row = static_cast<size_t>(blockIdx.x) * e_len;
  for (int j = threadIdx.x; j < n; j += kBinThreads) bucket[j] = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < e_len; e += kBinThreads) {
    // losers and padding carry pix = -1: no tile holds them
    const int32_t q = pix[row + e];
    if (q >= 0 && q < p_len) atomicAdd(&bucket[q / kTile], 1);
  }
  __syncthreads();
  // exclusive scan of the n counts in place: each thread a run of `per`
  const int per = (n + kBinThreads - 1) / kBinThreads;
  const int j0 = min(static_cast<int>(threadIdx.x) * per, n);
  const int j1 = min(j0 + per, n);
  int run = 0;
  for (int j = j0; j < j1; ++j) run += bucket[j];
  const int incl = warp_inclusive_sum(run);
  if ((threadIdx.x & 31) == 31) warp_total[threadIdx.x >> 5] = incl;
  __syncthreads();
  int at = incl - run;
  for (int wp = 0; wp < static_cast<int>(threadIdx.x >> 5); ++wp) at += warp_total[wp];
  for (int j = j0; j < j1; ++j) {
    const int c = bucket[j];
    bucket[j] = at;
    at += c;
  }
  __syncthreads();
  int32_t* off = offsets + static_cast<size_t>(blockIdx.x) * n;
  for (int j = threadIdx.x; j < n; j += kBinThreads) off[j] = bucket[j];
  __syncthreads();  // the starts are written before the slots advance them
  for (int e = threadIdx.x; e < e_len; e += kBinThreads) {
    const int32_t q = pix[row + e];
    if (q >= 0 && q < p_len) {
      const int tile = q / kTile;
      const int slot = atomicAdd(&bucket[tile], 1);
      entries[row + slot] =
          make_int2(q - tile * kTile, __float_as_int(contribution(dt[row + e], leak)));
    }
  }
}

__global__ void __launch_bounds__(kTile)
scan_events_kernel(const float* __restrict__ s0, const int2* __restrict__ entries,
                   const int32_t* __restrict__ offsets, const float* __restrict__ d,
                   float* __restrict__ out, int t_len, int e_len, int p_len, int n_tiles) {
  __shared__ float contrib[kWindow][kTile];
  __shared__ int seg_pre[kWindow + 1];  // exclusive prefix of the buckets' lengths
  __shared__ int seg_base[kWindow];     // entry index of flat position 0 of the bucket
  __shared__ float d_s[2][kWindow];     // by window parity: read while the next is loaded
  const int tile = blockIdx.x;
  const int p = tile * kTile + threadIdx.x;
  const bool live = p < p_len;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float s = live ? s0[p] : 0.0f;
#pragma unroll 8
  for (int k = 0; k < kWindow; ++k) contrib[k][threadIdx.x] = 0.0f;

  for (int t0 = 0, w = 0; t0 < t_len; t0 += kWindow, ++w) {
    const int n = min(kWindow, t_len - t0);
    float* dw = d_s[w & 1];
    if (warp == 0) {  // this tile's bucket of chunks t0 + 2 * lane and + 1
      int len[2], base[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = 2 * lane + i;
        len[i] = 0;
        base[i] = 0;
        if (k < n) {
          const int32_t* o = offsets + static_cast<size_t>(t0 + k) * (n_tiles + 1) + tile;
          const int a = o[0];
          len[i] = o[1] - a;
          base[i] = (t0 + k) * e_len + a;
        }
      }
      const int incl = warp_inclusive_sum(len[0] + len[1]);
      const int excl = incl - len[0] - len[1];
      seg_pre[2 * lane] = excl;
      seg_pre[2 * lane + 1] = excl + len[0];
      seg_base[2 * lane] = base[0] - excl;
      seg_base[2 * lane + 1] = base[1] - excl - len[0];
      if (lane == 31) seg_pre[kWindow] = incl;
    } else if (warp == 1) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (2 * lane + i < n) dw[2 * lane + i] = d[t0 + 2 * lane + i];
    }
    __syncthreads();  // buckets and decrements in; every column cleared
    const int total = seg_pre[kWindow];
    for (int f = threadIdx.x; f < total; f += kTile) {
      int k = 0;  // the last bucket starting at or before f
#pragma unroll
      for (int step = kWindow / 2; step > 0; step >>= 1)
        if (seg_pre[k + step] <= f) k += step;
      const int2 ev = entries[seg_base[k] + f];
      contrib[k][ev.x] = __int_as_float(ev.y);
    }
    __syncthreads();  // the window's contributions are placed
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float s1 = clamp0(__fsub_rn(s, dw[k]));
      s = clamp0(__fadd_rn(s1, contrib[k][threadIdx.x]));
      contrib[k][threadIdx.x] = 0.0f;  // cleared for the next window
      if (live) out[static_cast<size_t>(t0 + k) * p_len + p] = s;
    }
  }
}

// K2 replaces async_ev_cnn_tpu/ops/pallas_scan.py::surface_scan_pallas
// (_scan_kernel).  Bound: T*P*4 B of ts maps read plus T*P*4 B of surfaces
// written, a handful of float ops between them.  One thread a pixel walks
// T, and a pixel's chunks are a serial chain, so the card's parallelism is
// the P threads alone (35,840 at the eFCN's width, 271 an SM): to keep
// enough bytes in flight (about 3.35 TB/s x 1 us over 132 SMs, 25 KB an
// SM) each thread prefetches its ts values kTsWindow chunks ahead into
// registers, one window's loads issued before the window before it is
// walked (32 x 4 B a thread, 35 KB an SM).  A block is one warp of
// kTsTile pixels, so the eFCN's 1,120 blocks spread 8 or 9 to an SM, all
// resident at once.  Each lane also loads one chunk's d and last_ts of the
// next window, and every step takes them from the lane that holds them by
// a shuffle: no shared memory, no barrier.  Loads and stores are
// coalesced across the warp, and a pixel past P is never written.
__global__ void __launch_bounds__(kTsTile)
scan_tsmap_kernel(const float* __restrict__ s0, const int32_t* __restrict__ ts_map,
                  const float* __restrict__ d, const int32_t* __restrict__ last_ts,
                  float* __restrict__ out, int t_len, int p_len, float leak) {
  static_assert(kTsTile == 32 && kTsWindow == 32, "a warp a tile, a lane a chunk's scalars");
  const int lane = threadIdx.x;
  const int p = blockIdx.x * kTsTile + lane;
  const bool live = p < p_len;
  const int32_t* col = ts_map + (live ? p : p_len - 1);  // a dead lane reads a live column
  float s = live ? s0[p] : 0.0f;
  int32_t cur[kTsWindow], nxt[kTsWindow];
  float d_cur = 0.0f, d_nxt = 0.0f;
  int32_t lt_cur = 0, lt_nxt = 0;
  // window 0
#pragma unroll
  for (int k = 0; k < kTsWindow; ++k)
    cur[k] = k < t_len ? __ldg(col + static_cast<size_t>(k) * p_len) : 0;
  if (lane < t_len) {
    d_cur = __ldg(d + lane);
    lt_cur = __ldg(last_ts + lane);
  }
  for (int t0 = 0; t0 < t_len; t0 += kTsWindow) {
    const int t1 = t0 + kTsWindow;
    // the next window's loads, in flight while this one is walked
#pragma unroll
    for (int k = 0; k < kTsWindow; ++k)
      nxt[k] = t1 + k < t_len ? __ldg(col + static_cast<size_t>(t1 + k) * p_len) : 0;
    if (t1 + lane < t_len) {
      d_nxt = __ldg(d + t1 + lane);
      lt_nxt = __ldg(last_ts + t1 + lane);
    }
    const int n = min(kTsWindow, t_len - t0);
#pragma unroll
    for (int k = 0; k < kTsWindow; ++k) {
      if (k < n) {  // uniform across the warp
        const float dk = __shfl_sync(0xffffffffu, d_cur, k);
        const int32_t ltk = __shfl_sync(0xffffffffu, lt_cur, k);
        const int32_t tm = cur[k];
        const float s1 = clamp0(__fsub_rn(s, dk));
        // int32 difference with wraparound, as in the JAX package
        const int32_t dt =
            static_cast<int32_t>(static_cast<uint32_t>(ltk) - static_cast<uint32_t>(tm));
        const float a = tm > kTsSentinel ? contribution(dt, leak) : 0.0f;
        s = clamp0(__fadd_rn(s1, a));
        if (live) out[static_cast<size_t>(t0 + k) * p_len + p] = s;
      }
    }
#pragma unroll
    for (int k = 0; k < kTsWindow; ++k) cur[k] = nxt[k];
    d_cur = d_nxt;
    lt_cur = lt_nxt;
  }
}

}  // namespace

// C interface, bound with ctypes.  Each returns cudaGetLastError() (0 =
// success); pointers are device pointers, the stream is the caller's
// current stream.  The caller never passes t_len or p_len of 0 (the
// wrapper returns its empty output unlaunched).

// K1: the binning pass, then the scan.  workspace: int32, the [t_len,
// e_len] binned entries (two words each) and then the [t_len, n_tiles + 1]
// bucket offsets.  tile, window, n_tiles and bin_smem_bytes come from the
// plan (ops/surface_scan.scan_events_plan) and must be this source's.
extern "C" int surface_scan_events(const float* s0, const int32_t* pix,
                                   const int32_t* dt, const float* d, float* out,
                                   int32_t* workspace, int t_len, int e_len, int p_len,
                                   float leak, int tile, int window, int n_tiles,
                                   int bin_smem_bytes, cudaStream_t stream) {
  if (tile != kTile || window != kWindow || n_tiles != (p_len + kTile - 1) / kTile ||
      bin_smem_bytes != static_cast<int>(sizeof(int32_t)) * (n_tiles + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bin_smem_bytes > 48 * 1024) {  // above the default limit: opt in
    const cudaError_t opt_in = cudaFuncSetAttribute(
        bin_events_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bin_smem_bytes);
    if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  }
  int2* entries = reinterpret_cast<int2*>(workspace);
  int32_t* offsets = workspace + 2 * static_cast<size_t>(t_len) * e_len;
  bin_events_kernel<<<t_len, kBinThreads, bin_smem_bytes, stream>>>(
      pix, dt, entries, offsets, e_len, p_len, n_tiles, leak);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_events_kernel<<<n_tiles, kTile, 0, stream>>>(s0, entries, offsets, d, out, t_len,
                                                    e_len, p_len, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// K2: one launch.  tile, window and n_tiles come from the plan
// (ops/surface_scan.scan_tsmap_plan) and must be this source's.
extern "C" int surface_scan_tsmap(const float* s0, const int32_t* ts_map, const float* d,
                                  const int32_t* last_ts, float* out, int t_len, int p_len,
                                  float leak, int tile, int window, int n_tiles,
                                  cudaStream_t stream) {
  if (tile != kTsTile || window != kTsWindow || n_tiles != (p_len + kTsTile - 1) / kTsTile)
    return static_cast<int>(cudaErrorInvalidValue);
  scan_tsmap_kernel<<<n_tiles, kTsTile, 0, stream>>>(s0, ts_map, d, last_ts, out, t_len,
                                                     p_len, leak);
  return static_cast<int>(cudaGetLastError());
}
