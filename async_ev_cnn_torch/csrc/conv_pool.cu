// Fused conv + pool (C1) for Hopper (sm_90a):
// maxpool2x2(leaky(conv3x3_SAME(x, w) + b)) over C_in input channels, in IEEE
// float32, writing only the pooled map.
//
// Replaces no Pallas kernel: the JAX package leaves a conv, its bias, the
// activation and reduce_window to XLA, which fuses them itself.  In the port
// it runs the 'full' networks' 2x2/2-pooled 3x3 SAME stride-1 convs on the
// card that are not the one-channel stem (the eFCN's conv2-conv5,
// YOLOv3-tiny's conv2, conv4 and conv6), in place of cuDNN's conv and the
// pooled epilogue (csrc/conv_epilogue.cu), which wrote the unpooled map and
// read it back, wherever it gives their numbers bit for bit
// (layers/conv_stack.py decides).  x: f32 [N, C_in, H, W] (H, W even);
// w: f32 [C_pad, 9, O_pad], the OIHW kernel packed K-major (input channel,
// then tap dy-major, then output channel), zero past C_in and C_out; bias:
// f32 [O_pad] -> out: f32 [N, C_out, H/2, W/2].
//
// Bound: operations.  An eFCN pair at N = 1,024 frames is 84.56 GFLOP
// (1.262 ms at 67 TFLOP/s) against 0.88 GB read and written (0.26 ms at
// 3.35 TB/s); a YOLOv3-tiny pair 408.3 GFLOP (6.094 ms).  So the design
// spends its instructions on FFMA issue:
//
//   * the GEMM view: M = the pooling windows of all frames, flattened
//     (N x H/2 x W/2, so no tile is wasted at a frame's edge whatever its
//     width), N = the output channels, K = 9 x C_in.  A block owns kWindows
//     windows x kOTile channels; a thread 2 windows x 8 channels, 2 x 4 x 8
//     = 64 accumulators, so the 2x2 max runs in its registers and the
//     unpooled map is never stored;
//   * A is staged as each window's 4x4 input patch (the 3x3 taps of its
//     four pixels), [chunk][16][kWindows]: a thread reads its window pair's
//     value of a patch element as one 8-byte load, consecutive lanes on
//     consecutive pairs (no bank conflict), 16 loads a channel; B, the
//     weights, as [chunk][9][kOTile]: a tap's 8 channels are two 16-byte
//     loads that every lane of a warp shares (one channel group a warp: a
//     broadcast).  A channel is then 34 shared loads for 576 FFMA;
//   * the patches are gathered with 4-byte cp.async from the frames (zero
//     filled by the copy itself outside the frame, past C_in and past the
//     last window: SAME's halo), each thread copying one window's row(s)
//     of its patch, so a window's position is worked out once a tile; the
//     weights with 16-byte cp.async.  A 2-stage ring of kChunk input
//     channels (4 for the 32-channel tile, 8 for the 64-channel one: the
//     fastest of 2-4 stages of 2-8 channels at the route's seven pairs):
//     the copies of chunk s + 1 are in flight while chunk s is summed;
//   * a persistent grid (two blocks an SM: at most 128 registers, 73 or
//     100 KB of shared memory each) walks the tiles, window tile
//     major, and its ring runs on across tiles, so a block never waits at
//     a tile's start;
//   * numerics: acc = 0, then acc = fma(x, w, acc) for each input channel
//     in order and each of its taps dy-major: one rounding a product, an
//     IEEE float32 FMA (no TF32, no Winograd, no FFT; an explicit fma is
//     fused whatever --fmad says).  Then, in registers, the 2x2 max of the
//     raw sums, one rounded add of the bias and the activation max(v,
//     alpha * v): for 0 < alpha <= 1 both are nondecreasing, so this is
//     the pooled epilogue's result on these sums (the entry refuses any
//     other alpha).  The order is cuDNN's implicit GEMM's (k = input
//     channel x 9 + tap), so where cuDNN runs one the two agree bit for
//     bit; against its FFT, or the plain version, they differ by the
//     roundings of the sums (ops/conv_pool.py's C1_TOL bounds it).
//
// Tile instances (kOTile 32 or 64; kWindows = 4096 / kOTile, a block's
// 256 threads; kChunk 4 or 8) are chosen by the caller from C_out and
// checked here.
//
// Built by async_ev_cnn_torch/ops/cuda_build.py; bound with ctypes by
// async_ev_cnn_torch/ops/conv_pool.py, whose CHUNKS and O_TILES are these.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 2;         // stages of the copy ring
constexpr int kPatch = 16;         // a window's 4x4 input patch
constexpr int kOThread = 8;        // output channels a thread
constexpr int kSmemLimit = 232448; // shared memory one block of the H100 may use

template <int kOTile>
struct Tile {
  // input channels a stage: 4 for the 32-channel tile (its patches are
  // twice the 64-channel tile's, 128 windows), 8 for the 64-channel one
  static constexpr int kChunk = kOTile == 32 ? 4 : 8;
  static constexpr int kGroups = kOTile / kOThread;         // channel groups a block
  static constexpr int kPairs = kThreads / kGroups;         // window pairs a block
  static constexpr int kWindows = 2 * kPairs;               // windows a block
  static constexpr int kRows = 4 * kWindows / kThreads;     // patch rows a thread copies
  static constexpr int kA = kChunk * kPatch * kWindows;     // floats of patches a stage
  static constexpr int kB = kChunk * 9 * kOTile;            // floats of weights a stage
  static constexpr int kStage = kA + kB;
  static constexpr int kSmem = kStages * kStage * static_cast<int>(sizeof(float));
  static_assert(kPairs % 32 == 0, "a warp must hold one channel group");
  static_assert(kOTile == 32 || kOTile == 64, "the instances the entry takes");
  static_assert(kRows >= 1 && kRows * kThreads == 4 * kWindows, "patch rows split evenly");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 4 bytes, through L1 (neighbouring windows share their
// patches' edges); with src_bytes 0 it writes a zero
__device__ __forceinline__ void copy4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a max that passes NaN through, as the pooled epilogue's
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct Shape {
  int c_in, h, wd, c_out;
  int wp, plane;       // pooled columns, and windows a frame
  int m_total;         // windows in all
  int n_chunks;        // input-channel chunks: C_pad / the tile's kChunk
  int o_tiles;         // channel tiles: O_pad / kOTile
  int n_tiles;
  float alpha;
};

// The copies of one step (a tile's input-channel chunk) into a stage.
// Each thread copies patch rows [row0, row0 + kRows) of window `lm`;
// `base` is that window's offset of (input channel 0, row row0 - 1 + 2 py,
// column 2 px - 1) in x, `mask` bit 4 r + c whether row row0 + r, column
// c of the patch lies inside the frame (0 past the last window).
template <int kOTile>
__device__ __forceinline__ void stage_step(float* stage, const float* __restrict__ x,
                                           const float* __restrict__ w, const Shape& s,
                                           int chunk, int ot, int lm, int row0,
                                           long long base, uint32_t mask) {
  using T = Tile<kOTile>;
  constexpr int kChunk = T::kChunk;
  const long long hw = static_cast<long long>(s.h) * s.wd;
  float* a = stage + row0 * 4 * T::kWindows + lm;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int ci = chunk * kChunk + j;
    const uint32_t m = ci < s.c_in ? mask : 0u;
    const long long off = base + ci * hw;
#pragma unroll
    for (int r = 0; r < T::kRows; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = (m >> (4 * r + c)) & 1u;
        copy4(a + (j * kPatch + 4 * r + c) * T::kWindows,
              ok ? x + (off + static_cast<long long>(r) * s.wd + c) : x, ok ? 4 : 0);
      }
  }
  // weights: kChunk x 9 rows of kOTile floats, 16 bytes a copy
  const int o_pad = s.o_tiles * kOTile;
  const float* src = w + static_cast<size_t>(chunk) * kChunk * 9 * o_pad + ot * kOTile;
  float* b = stage + T::kA;
  constexpr int kQuads = kOTile / 4;
  for (int i = threadIdx.x; i < kChunk * 9 * kQuads; i += kThreads) {
    const int row = i / kQuads, q = i - row * kQuads;
    copy16(b + row * kOTile + 4 * q, src + static_cast<size_t>(row) * o_pad + 4 * q);
  }
}

template <int kOTile>
__global__ void __launch_bounds__(kThreads, 2)
conv_pool_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out, const Shape s) {
  using T = Tile<kOTile>;
  constexpr int kChunk = T::kChunk;
  extern __shared__ __align__(16) float smem[];  // [kStages][kA + kB]

  // the copying role: window lm of the tile, patch rows row0 ..
  const int lm = threadIdx.x % T::kWindows;
  const int row0 = threadIdx.x / T::kWindows * T::kRows;
  // the summing role: channel group g (a warp's), window pair p
  const int g = threadIdx.x / T::kPairs;
  const int p = threadIdx.x % T::kPairs;

  const int my_tiles = blockIdx.x < s.n_tiles
                           ? (s.n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_steps = my_tiles * s.n_chunks;

  // the copier's step: its tile (global index), chunk, window offset and mask
  int ld_tile = blockIdx.x, ld_chunk = 0;
  long long ld_base = 0;
  uint32_t ld_mask = 0;
  auto locate = [&](int tile) {
    const int gm = tile / s.o_tiles * T::kWindows + lm;
    ld_mask = 0;
    if (gm < s.m_total) {
      const int n = gm / s.plane;
      const int rem = gm - n * s.plane;
      const int py = rem / s.wp, px = rem - py * s.wp;
      const int y0 = 2 * py - 1 + row0, x0 = 2 * px - 1;
      ld_base = static_cast<long long>(n) * s.c_in * s.h * s.wd +
                static_cast<long long>(y0) * s.wd + x0;
#pragma unroll
      for (int r = 0; r < T::kRows; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (y0 + r >= 0 && y0 + r < s.h && x0 + c >= 0 && x0 + c < s.wd)
            ld_mask |= 1u << (4 * r + c);
    }
  };
  auto issue = [&](int step) {
    if (step < n_steps) {
      if (ld_chunk == 0) locate(ld_tile);
      stage_step<kOTile>(smem + (step % kStages) * T::kStage, x, w, s, ld_chunk,
                         ld_tile % s.o_tiles, lm, row0, ld_base, ld_mask);
      if (++ld_chunk == s.n_chunks) {
        ld_chunk = 0;
        ld_tile += gridDim.x;
      }
    }
    copy_commit();
  };

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(k);

  float acc[2][4][kOThread];
#pragma unroll
  for (int v = 0; v < 2; ++v)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int o = 0; o < kOThread; ++o) acc[v][q][o] = 0.0f;

  int tile = blockIdx.x, chunk = 0;
  for (int step = 0; step < n_steps; ++step) {
    copy_wait<kStages - 2>();  // this step's copies have landed (later ones may not)
    __syncthreads();           // ... everyone's, and the stage refilled next is read
    issue(step + kStages - 1);
    const float* a = smem + (step % kStages) * T::kStage + 2 * p;
    const float* b = smem + (step % kStages) * T::kStage + T::kA + kOThread * g;
#pragma unroll 1
    for (int j = 0; j < kChunk; ++j) {
      float2 v[kPatch];
#pragma unroll
      for (int e = 0; e < kPatch; ++e)
        v[e] = *reinterpret_cast<const float2*>(a + (j * kPatch + e) * T::kWindows);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        const float4 w0 = *reinterpret_cast<const float4*>(b + (j * 9 + tap) * kOTile);
        const float4 w1 = *reinterpret_cast<const float4*>(b + (j * 9 + tap) * kOTile + 4);
        const float wt[kOThread] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 xv = v[(q / 2 + dy) * 4 + q % 2 + dx];
#pragma unroll
          for (int o = 0; o < kOThread; ++o) {
            acc[0][q][o] = __fmaf_rn(xv.x, wt[o], acc[0][q][o]);
            acc[1][q][o] = __fmaf_rn(xv.y, wt[o], acc[1][q][o]);
          }
        }
      }
    }
    if (++chunk < s.n_chunks) continue;
    // the tile's last chunk: pool, bias, activate and store, then start over
    const int mt = tile / s.o_tiles, o0 = (tile - mt * s.o_tiles) * kOTile + kOThread * g;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int gm = mt * T::kWindows + 2 * p + v;
      if (gm < s.m_total) {
        const int n = gm / s.plane;
        const int rem = gm - n * s.plane;
        float* dst = out + static_cast<size_t>(n) * s.c_out * s.plane + rem;
#pragma unroll
        for (int o = 0; o < kOThread; ++o) {
          if (o0 + o < s.c_out) {
            const float mx = max_nan(max_nan(acc[v][0][o], acc[v][1][o]),
                                     max_nan(acc[v][2][o], acc[v][3][o]));
            const float u = __fadd_rn(mx, __ldg(bias + o0 + o));
            dst[static_cast<size_t>(o0 + o) * s.plane] = max_nan(u, __fmul_rn(u, s.alpha));
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int o = 0; o < kOThread; ++o) acc[v][q][o] = 0.0f;
    }
    chunk = 0;
    tile += gridDim.x;
  }
  copy_wait<0>();  // no copy outlives the block (the last ones are empty)
}

template <int kOTile>
int launch(const float* x, const float* w, const float* bias, float* out, const Shape& s,
           cudaStream_t stream) {
  using T = Tile<kOTile>;
  auto kernel = conv_pool_kernel<kOTile>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long slots = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(s.n_tiles < slots ? s.n_tiles : slots);
  kernel<<<grid, kThreads, T::kSmem, stream>>>(x, w, bias, out, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes; returns a CUDA error code (0 = success).
// x: f32 [n, c_in, h, wd] (h, wd even), w: f32 [C_pad, 9, O_pad] and bias:
// f32 [O_pad] (C_pad = c_in rounded up to the tile's kChunk, O_pad = c_out
// rounded up to o_tile, zero past c_in and c_out), out: f32 [n, c_out, h/2, wd/2], all
// on the device; the kernel runs on `stream`.  Refuses an o_tile that is no
// instance, an alpha outside (0, 1] (the pool would not commute with the
// activation), odd dims, and counts of windows, tiles or elements past
// int32.
extern "C" int conv_pool(const float* x, const float* w, const float* bias, float* out,
                         int n, int c_in, int h, int wd, int c_out, int o_tile, float alpha,
                         cudaStream_t stream) {
  if (n < 1 || c_in < 1 || c_out < 1 || h < 2 || wd < 2 || (h | wd) & 1 ||
      !(alpha > 0.0f && alpha <= 1.0f) || (o_tile != 32 && o_tile != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s;
  s.c_in = c_in;
  s.h = h;
  s.wd = wd;
  s.c_out = c_out;
  s.wp = wd / 2;
  s.alpha = alpha;
  const long long plane = static_cast<long long>(h / 2) * s.wp;
  const long long m_total = plane * n;
  const long long windows = o_tile == 32 ? Tile<32>::kWindows : Tile<64>::kWindows;
  const long long o_tiles = (c_out + o_tile - 1) / o_tile;
  const long long n_tiles = (m_total + windows - 1) / windows * o_tiles;
  const long long limit = 0x7fffffffLL - (1 << 20);
  if (m_total > limit || n_tiles > limit || plane * c_out > limit ||
      static_cast<long long>(h) * wd > limit)
    return static_cast<int>(cudaErrorInvalidValue);
  s.plane = static_cast<int>(plane);
  s.m_total = static_cast<int>(m_total);
  const int chunk = o_tile == 32 ? Tile<32>::kChunk : Tile<64>::kChunk;
  s.n_chunks = (c_in + chunk - 1) / chunk;
  s.o_tiles = static_cast<int>(o_tiles);
  s.n_tiles = static_cast<int>(n_tiles);
  static_assert(Tile<32>::kSmem <= kSmemLimit && Tile<64>::kSmem <= kSmemLimit,
                "a stage ring past a block's shared memory");
  return o_tile == 32 ? launch<32>(x, w, bias, out, s, stream)
                      : launch<64>(x, w, bias, out, s, stream);
}
