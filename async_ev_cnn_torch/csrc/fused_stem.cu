// Fused eFCN stem (K6) for Hopper (sm_90a): maxpool2x2(leaky(conv3x3_SAME(x) + b))
// for a one-channel input, in one kernel.
//
// Replaces examples/pallas_stem_negative.py::fused_stem (_stem_kernel), a
// measured alternative to the library stem that the JAX package keeps
// beside it (not on its path).  In the port it runs every 'full' network's
// one-channel stem pair on the card (layers/conv_stack.py: the eFCN's conv1
// -> pool1, YOLOv3-tiny's conv0 -> pool1).  x: f32 [T, H, W] (H, W even);
// w: f32 [9, O] taps, dy-major; bias: f32 [O] -> out: f32 [T, O, H/2, W/2].
//
// The direct stem writes the [T, O, H, W] conv output to device memory and
// reads it back for the pool (459 MB each way at T=200, 160x224, O=16);
// this kernel keeps it on chip.  Bound at that shape: 28.7 MB read and
// 114.7 MB written (42.8 us at 3.35 TB/s) against 1.03e9 multiply-adds
// (31 us of FFMA at 67 TFLOP/s): bytes, with the FFMA issue close behind,
// so the design spends as few instructions as it can per output:
//
//   * one rounding per tap: acc = 0, then acc = fma(x, w, acc) tap by tap,
//     dy-major, and the bias added after the 2x2 max, in one rounded add:
//     the roundings of the library stem, cuDNN's conv followed by the
//     pooled epilogue (csrc/conv_epilogue.cu), so the two agree bit for
//     bit wherever cuDNN sums the nine taps in that order (on the H100 at
//     every shape tried; tests/test_torch_conv_epilogue_chip.py holds a
//     served dispatch to the unfused layers).  An explicit fma is fused
//     whatever --fmad says.  The plain version in
//     ops/fused_stem.py keeps the TPU kernel's order (acc = b first,
//     product and sum rounded apart), so the two differ by a few ulps
//     (ops/fused_stem.py's K6_TOL bounds it), not bit for bit;
//   * the taps and bias go to the kernel by value, in a __grid_constant__
//     parameter struct (StemWeights: 9 * kMaxO + kMaxO floats, 2,560 B,
//     under the 4 KB of a launch's parameters), so they sit in the
//     constant bank with no copy before the launch and no weight is loaded
//     from shared or device memory in the loop; the channel loop is
//     unrolled with O a template argument (the eFCN's and YOLOv3-tiny's
//     16; any other O <= kMaxO takes the generic instance, a runtime loop);
//   * pool, then add the bias and activate: for 0 <= alpha <= 1,
//     where(v > 0, v, alpha * v) equals max(v, alpha * v), and it and the
//     bias add are monotone under round-to-nearest, so the activation of
//     the 2x2 max is the max of the activations: three instructions a
//     pooled pixel instead of sixteen.  Any other alpha keeps the TPU
//     kernel's order, bias and activation on each conv value before the
//     max (an instance of its own, picked on the host: no branch in the
//     loop);
//   * each thread owns 2x2 pooled pixels: a 6x6 input patch in registers
//     (one float4 and one float2 shared-memory read a row), 16 conv values
//     a channel, two float2 stores a channel, so the per-channel cost of
//     the weights, the bias and the store addresses is shared by four
//     pooled pixels (about 126 registers, so two blocks an SM; a pooled
//     pair a thread fitted three blocks but took longer, PERF.md).  A tile
//     is kBand pooled rows of one frame, kBand / 2 x ceil(W/4) items: at
//     W = 224 that is 4 x 56 = 224 items for the kThreads = 224 threads,
//     one pass and no idle lane;
//   * a persistent grid (as many blocks as fit on the card at once) walks
//     the T x ceil(H/2 / kBand) tiles, frame by frame, through a two-stage
//     cp.async ring: the next tile's 2 * kBand + 2 input rows (with the
//     SAME halo, zero-filled by the copies themselves) load while this one
//     computes.  4-byte copies: TMA would need the row stride a multiple
//     of 16 bytes, and W need only be even.
//
// Each launch carries its own weights, so calls on any streams are
// independent of one another.  The caller hands the taps and bias over
// from host memory: the struct is filled on the host at the launch.
//
// Built by async_ev_cnn_torch/ops/cuda_build.py; bound with ctypes by
// async_ev_cnn_torch/ops/fused_stem.py, whose STEM_* constants are these.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kBand = 8;               // pooled rows a tile
constexpr int kThreads = 224;          // 7 warps: a 224-wide tile's items
constexpr int kRows = 2 * kBand + 2;   // staged input rows with the halo
constexpr int kMaxO = 64;              // output channels the parameter struct holds
constexpr int kSmemLimit = 232448;     // shared memory one block of the H100 may use

// the weights of a launch, passed by value: taps [9, o_len] dy-major, then
// the bias; the entries past o_len are unused
struct StemWeights {
  float taps[9 * kMaxO];
  float bias[kMaxO];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 4 bytes; with src_bytes 0 it writes a zero
__device__ __forceinline__ void copy4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float leaky(float v, float alpha) {
  return v > 0.0f ? v : __fmul_rn(alpha, v);
}

// staged width: input columns -1 .. 4 * ceil(W/4) + 2 (the last item's
// patch, zero past the frame), rounded up to 4 floats so that every row
// starts 16-byte aligned
__host__ __device__ inline int stage_width(int wd) {
  return ((wd / 2 + 1) / 2 * 4 + 2 + 3) / 4 * 4;
}

// issue the copies of tile (t, band) into stage s: kRows rows of sw floats,
// staged row r / column c holding input row 2 * band * kBand - 1 + r,
// column c - 1, or zero outside the frame
__device__ __forceinline__ void stage_tile(float* s, const float* __restrict__ x, int t,
                                           int band, int h, int wd, int sw) {
  const float* frame = x + static_cast<size_t>(t) * h * wd;
  const int y0 = 2 * band * kBand - 1;
  for (int c = threadIdx.x; c < sw; c += kThreads) {
    const int xi = c - 1;
    const bool col_ok = xi >= 0 && xi < wd;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int y = y0 + r;
      const bool ok = col_ok && y >= 0 && y < h;
      copy4(s + r * sw + c, ok ? frame + static_cast<size_t>(y) * wd + xi : x, ok ? 4 : 0);
    }
  }
}

// one output channel of a thread's 2x2 pooled pixels: 16 conv sums, the
// 2x2 maxes, the bias and the activation, the stores (row 1 only where
// the band has it, column 1 only where the frame has it)
template <bool kPoolFirst>
__device__ __forceinline__ void channel(const float (&v)[6][6], const float* taps, float b,
                                        float alpha, float* dst, int wp, bool vec, bool pair,
                                        bool row2) {
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const float w = taps[dy * 3 + dx];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = __fmaf_rn(v[a + dy][c + dx], w, acc[a][c]);
    }
  float m[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float p00 = acc[2 * i][2 * j], p01 = acc[2 * i][2 * j + 1];
      const float p10 = acc[2 * i + 1][2 * j], p11 = acc[2 * i + 1][2 * j + 1];
      if constexpr (kPoolFirst) {  // 0 <= alpha <= 1
        const float mx = __fadd_rn(fmaxf(fmaxf(p00, p01), fmaxf(p10, p11)), b);
        m[i][j] = fmaxf(mx, __fmul_rn(alpha, mx));
      } else {
        m[i][j] = fmaxf(fmaxf(leaky(__fadd_rn(p00, b), alpha), leaky(__fadd_rn(p01, b), alpha)),
                        fmaxf(leaky(__fadd_rn(p10, b), alpha), leaky(__fadd_rn(p11, b), alpha)));
      }
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i == 1 && !row2) break;
    float* d = dst + i * wp;
    if (vec) {
      *reinterpret_cast<float2*>(d) = make_float2(m[i][0], m[i][1]);
    } else {
      d[0] = m[i][0];
      if (pair) d[1] = m[i][1];
    }
  }
}

// kO > 0: the channel loop unrolled at O = kO, weights at constant
// offsets; kO == 0: any O <= kMaxO, a runtime loop
template <int kO, bool kPoolFirst>
__global__ void __launch_bounds__(kThreads, 2)
fused_stem_kernel(const __grid_constant__ StemWeights wts, const float* __restrict__ x,
                  float* __restrict__ out, int t_len, int h, int wd, int o_rt, int n_bands,
                  float alpha) {
  extern __shared__ __align__(16) float smem[];  // [2][kRows][sw]
  const int o_len = kO > 0 ? kO : o_rt;
  const int hp = h / 2, wp = wd / 2;
  const int n_pairs = (wp + 1) / 2;
  const int sw = stage_width(wd);
  const int stage_len = kRows * sw;
  const size_t plane = static_cast<size_t>(hp) * wp;
  const int n_tiles = t_len * n_bands;
  // a float2 store is 8-byte aligned when every output row starts at an
  // even float; an odd width stores its pixels one by one
  const bool even_wp = (wp & 1) == 0;

  int tile = blockIdx.x;
  if (tile < n_tiles) stage_tile(smem, x, tile / n_bands, tile % n_bands, h, wd, sw);
  copy_commit();
  for (int k = 0; tile < n_tiles; tile += gridDim.x, ++k) {
    const int next = tile + gridDim.x;
    if (next < n_tiles)
      stage_tile(smem + ((k + 1) & 1) * stage_len, x, next / n_bands, next % n_bands, h, wd,
                 sw);
    copy_commit();
    copy_wait<1>();   // this tile's copies have landed (the next tile's may not)
    __syncthreads();  // ... everyone's
    const float* s = smem + (k & 1) * stage_len;
    const int t = tile / n_bands;
    const int py0 = (tile - t * n_bands) * kBand;
    const int rows_here = min(kBand, hp - py0);
    const int items = (rows_here + 1) / 2 * n_pairs;
    for (int i = threadIdx.x; i < items; i += kThreads) {
      const int r = i / n_pairs;  // pooled rows 2r, 2r + 1 of the band
      const int q = i - r * n_pairs;  // pooled columns 2q, 2q + 1
      // the 6x6 input patch under the four 2x2 windows: staged rows
      // 4r .. 4r+5, columns 4q .. 4q+5
      float v[6][6];
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        const float* row = s + (4 * r + a) * sw + 4 * q;
        const float4 u = *reinterpret_cast<const float4*>(row);
        const float2 z = *reinterpret_cast<const float2*>(row + 4);
        v[a][0] = u.x;
        v[a][1] = u.y;
        v[a][2] = u.z;
        v[a][3] = u.w;
        v[a][4] = z.x;
        v[a][5] = z.y;
      }
      const bool pair = 2 * q + 1 < wp;         // false at the last pair of an odd width
      const bool row2 = 2 * r + 1 < rows_here;  // false at the last row of an odd band
      float* dst = out + (static_cast<size_t>(t) * o_len * hp + py0 + 2 * r) * wp + 2 * q;
      if constexpr (kO > 0) {
#pragma unroll
        for (int o = 0; o < kO; ++o) {
          float taps[9];
#pragma unroll
          for (int j = 0; j < 9; ++j) taps[j] = wts.taps[j * kO + o];
          channel<kPoolFirst>(v, taps, wts.bias[o], alpha, dst, wp, even_wp, pair, row2);
          dst += plane;
        }
      } else {
#pragma unroll 1
        for (int o = 0; o < o_len; ++o) {
          float taps[9];
#pragma unroll
          for (int j = 0; j < 9; ++j) taps[j] = wts.taps[j * o_len + o];
          channel<kPoolFirst>(v, taps, wts.bias[o], alpha, dst, wp, even_wp, pair, row2);
          dst += plane;
        }
      }
    }
    __syncthreads();  // this stage is read before the copies of tile + 2 * grid refill it
  }
}

template <int kO, bool kPoolFirst>
int launch(const StemWeights& wts, const float* x, float* out, int t_len, int h, int wd,
           int o_len, float alpha, cudaStream_t stream) {
  auto kernel = fused_stem_kernel<kO, kPoolFirst>;
  const int smem = static_cast<int>(sizeof(float)) * 2 * kRows * stage_width(wd);
  if (smem > 48 * 1024) {
    const cudaError_t opt_in =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_bands = (h / 2 + kBand - 1) / kBand;
  const long long n_tiles = static_cast<long long>(t_len) * n_bands;
  const int grid = static_cast<int>(n_tiles < static_cast<long long>(sms) * per_sm
                                        ? n_tiles : static_cast<long long>(sms) * per_sm);
  kernel<<<grid, kThreads, smem, stream>>>(wts, x, out, t_len, h, wd, o_len, n_bands, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes; returns a CUDA error code (0 = success).
// x: f32 [t_len, h, wd] (h, wd even) and out: f32 [t_len, o_len, h / 2,
// wd / 2] on the device; w: f32 [9, o_len] and bias: f32 [o_len] in host
// memory, copied into the launch's parameters.  The kernel runs on
// `stream`.  Refuses o_len outside 1..kMaxO, a tile count past int32, and
// a width whose two stages exceed a block's shared memory.
extern "C" int fused_stem(const float* x, const float* w, const float* bias, float* out,
                          int t_len, int h, int wd, int o_len, float alpha,
                          cudaStream_t stream) {
  if (o_len < 1 || o_len > kMaxO || t_len < 1 || h < 2 || wd < 2 || (h | wd) & 1 ||
      static_cast<long long>(t_len) * ((h / 2 + kBand - 1) / kBand) > 0x7fffffffLL - (1 << 20) ||
      static_cast<long long>(sizeof(float)) * 2 * kRows * stage_width(wd) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  StemWeights wts{};
  std::memcpy(wts.taps, w, sizeof(float) * 9 * o_len);
  std::memcpy(wts.bias, bias, sizeof(float) * o_len);
  const bool pool_first = alpha >= 0.0f && alpha <= 1.0f;  // false for a NaN alpha
  if (o_len == 16)
    return (pool_first ? launch<16, true> : launch<16, false>)(wts, x, out, t_len, h, wd,
                                                                o_len, alpha, stream);
  return (pool_first ? launch<0, true> : launch<0, false>)(wts, x, out, t_len, h, wd, o_len,
                                                            alpha, stream);
}
