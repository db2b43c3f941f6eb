// Leaky-surface scan kernels for Hopper (sm_90a).
//
// Both kernels produce all T chunk-boundary surfaces of the integration
// layer in one pass: per pixel, per chunk t,
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
// Both kernels keep one pixel's running surface in a register of one
// thread across the whole T loop: pixels are independent, time is
// sequential.  They are bound by device-memory bytes: the T*P*4 bytes of
// surfaces they must write (and, for the ts-map kernel, the same again of
// ts maps read); the arithmetic is a handful of float ops per pixel and
// chunk.  Each thread reads and writes its pixel at consecutive addresses
// across a warp (coalesced), and no chunk's output is written twice.
//
// Built by async_ev_cnn_torch/ops/cuda_build.py; bound with ctypes by
// async_ev_cnn_torch/ops/surface_scan.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // pixels per block, one per thread
constexpr float kSnapUp = 1048576.0f;            // 2^20 (SNAP_BITS)
constexpr float kSnapDown = 1.0f / 1048576.0f;   // 2^-20, exact
constexpr int32_t kTsSentinel = -2147483647;     // -(2^31) + 1: no event

__device__ __forceinline__ float snap(float x) {
  return __fmul_rn(rintf(__fmul_rn(x, kSnapUp)), kSnapDown);
}

__device__ __forceinline__ float clamp0(float s) { return s <= 0.0f ? 0.0f : s; }

__device__ __forceinline__ float contribution(int32_t dt, float leak) {
  return __fsub_rn(1.0f, snap(__fmul_rn(__int2float_rn(dt), leak)));
}

// Replaces async_ev_cnn_tpu/ops/pallas_scan.py::surface_scan_events_pallas
// (_scan_events_kernel).  The TPU kernel has no scatter, so it places each
// chunk's winners by a bf16 one-hot matrix product with 8-bit dt limbs.
// Here a block owns a tile of kThreads pixels; per chunk its threads read
// the chunk's <= E winners (coalesced: thread i reads event i), and each
// winner that falls in the tile is written into a shared-memory
// contribution tile.  After the dedup of ops/integrate.chunk_event_updates
// each pixel has at most one winner per chunk, so plain stores are exact
// and need no atomics.  Each event is used once per block, so the event
// list is read straight from global memory (an L2 hit after the first
// block) rather than copied to shared memory first.
//
// Bound: the T*P*4 bytes of surfaces written, plus the P*4 B surface, the
// T*E*8 B of winner lists and the T*4 B of decrements read once.  Every
// block re-reads each chunk's event list from L2 (P/kThreads times in all);
// the fused dedup and TMA staging of a faster design are later work.
__global__ void __launch_bounds__(kThreads)
scan_events_kernel(const float* __restrict__ s0, const int32_t* __restrict__ pix,
                   const int32_t* __restrict__ dt, const float* __restrict__ d,
                   float* __restrict__ out, int t_len, int e_len, int p_len,
                   float leak) {
  __shared__ float contrib[kThreads];
  const int base = blockIdx.x * kThreads;
  const int p = base + threadIdx.x;
  const bool live = p < p_len;
  const int tile_end = min(base + kThreads, p_len);
  float s = live ? s0[p] : 0.0f;
  for (int t = 0; t < t_len; ++t) {
    contrib[threadIdx.x] = 0.0f;
    __syncthreads();
    const int32_t* pix_t = pix + static_cast<size_t>(t) * e_len;
    const int32_t* dt_t = dt + static_cast<size_t>(t) * e_len;
    for (int e = threadIdx.x; e < e_len; e += kThreads) {
      // losers and padding carry pix = -1, which no tile holds
      const int32_t q = pix_t[e];
      if (q >= base && q < tile_end) {
        contrib[q - base] = contribution(dt_t[e], leak);
      }
    }
    __syncthreads();
    const float s1 = clamp0(__fsub_rn(s, d[t]));
    s = clamp0(__fadd_rn(s1, contrib[threadIdx.x]));
    if (live) out[static_cast<size_t>(t) * p_len + p] = s;
    __syncthreads();  // the tile is cleared at the top of the next chunk
  }
}

// Replaces async_ev_cnn_tpu/ops/pallas_scan.py::surface_scan_pallas
// (_scan_kernel).  One thread per pixel walks T, reading its pixel of each
// chunk's int32 ts map (coalesced across the warp) and writing its
// surface.  The per-chunk scalars d and last_ts are staged in shared
// memory kThreads chunks at a time, so every thread reads them from there.
//
// Bound: T*P*4 B of ts maps read plus T*P*4 B of surfaces written.
__global__ void __launch_bounds__(kThreads)
scan_tsmap_kernel(const float* __restrict__ s0, const int32_t* __restrict__ ts_map,
                  const float* __restrict__ d, const int32_t* __restrict__ last_ts,
                  float* __restrict__ out, int t_len, int p_len, float leak) {
  __shared__ float d_s[kThreads];
  __shared__ int32_t lt_s[kThreads];
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < p_len;
  float s = live ? s0[p] : 0.0f;
  for (int t0 = 0; t0 < t_len; t0 += kThreads) {
    const int n = min(kThreads, t_len - t0);
    if (threadIdx.x < n) {
      d_s[threadIdx.x] = d[t0 + threadIdx.x];
      lt_s[threadIdx.x] = last_ts[t0 + threadIdx.x];
    }
    __syncthreads();
    if (live) {
      for (int i = 0; i < n; ++i) {
        const size_t at = static_cast<size_t>(t0 + i) * p_len + p;
        const int32_t tm = ts_map[at];
        const float s1 = clamp0(__fsub_rn(s, d_s[i]));
        // int32 difference with wraparound, as in the JAX package
        const int32_t dt = static_cast<int32_t>(
            static_cast<uint32_t>(lt_s[i]) - static_cast<uint32_t>(tm));
        const float a = tm > kTsSentinel ? contribution(dt, leak) : 0.0f;
        s = clamp0(__fadd_rn(s1, a));
        out[at] = s;
      }
    }
    __syncthreads();  // d_s / lt_s are refilled for the next chunk block
  }
}

int blocks_for(int p_len) { return (p_len + kThreads - 1) / kThreads; }

}  // namespace

// C interface, bound with ctypes.  Each launches its kernel once and
// returns cudaGetLastError() (0 = success); pointers are device pointers,
// the stream is the caller's current stream.  The caller never passes
// t_len or p_len of 0 (the wrapper returns its empty output unlaunched).

extern "C" int surface_scan_events(const float* s0, const int32_t* pix,
                                   const int32_t* dt, const float* d, float* out,
                                   int t_len, int e_len, int p_len, float leak,
                                   cudaStream_t stream) {
  scan_events_kernel<<<blocks_for(p_len), kThreads, 0, stream>>>(
      s0, pix, dt, d, out, t_len, e_len, p_len, leak);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int surface_scan_tsmap(const float* s0, const int32_t* ts_map,
                                  const float* d, const int32_t* last_ts,
                                  float* out, int t_len, int p_len, float leak,
                                  cudaStream_t stream) {
  scan_tsmap_kernel<<<blocks_for(p_len), kThreads, 0, stream>>>(
      s0, ts_map, d, last_ts, out, t_len, p_len, leak);
  return static_cast<int>(cudaGetLastError());
}
