// L1: the LayerNorm of RVT's tokens for Hopper (sm_90a), with the window or
// grid partition of the attention that reads them folded into its store.
//
// Replaces no Pallas kernel: the JAX package runs no transformer.  Added
// because PyTorch's LayerNorm gives each token (a row of C = 64 to 512
// channels) a block of its own and reads it with one warp, about a fifth of
// the card's memory bandwidth at RVT's 15.7 M stage-1 tokens a dispatch,
// and the partition that follows each pre-norm is one more pass over the
// map.
//
// x: f32 tokens of N frames of H x W pixels and C channels, at any strides
// whose pixels merge (frame, pixel, channel strides in floats): a
// channels-last map, or a channels-first one (a conv's NCHW output);
// out: f32 [N * H * W, C], each token a contiguous row, in the order of the
// input (kind 0), of RVT's window partition (kind 1: ph x pw tiles) or of
// its grid partition (kind 2: ph x pw tokens H / ph and W / pw apart),
// each partition's tokens in row-major order.  norm = 1: out = (x - mean) *
// rstd * gamma + beta, mean and variance over the C channels, rstd =
// 1 / sqrt(var + eps), each sum a warp's in float32, each operation
// rounded on its own (--fmad=false); norm = 0: out = x, the partition
// alone (the window half that follows an embedding, already normed).
//
// Bound: bytes.  Each element is read once and written once: at RVT-B's
// five passes a stage, 75.5 GB a 1,024-frame dispatch, 22.5 ms at 3.35
// TB/s.  So:
//   * a block stages a tile of 8,192 / C whole tokens in shared memory
//     (32 KB); for a channels-first load the rows are padded by one float,
//     so that its threads (consecutive pixels of one channel) fall on
//     distinct banks;
//   * the load runs along the input's contiguous axis (channels, 16 bytes
//     a thread, or pixels for a channels-first map), the store along each
//     output row, 16 bytes a thread: both coalesced whatever the
//     partition, a token's place in it worked out once for four channels;
//   * a warp a token for the statistics, from shared memory; 256 threads,
//     no other state, enough blocks in flight (1,900 at stage 1's 2.1 M
//     tokens a call) to cover the memory's latency.
// Tokens count in 32 bits (a call takes fewer than 2^31), offsets in 64.
// The entry refuses C that is not a multiple of 4 from 4 to 512, a
// partition that does not tile the frame, strides whose pixels do not
// merge, and a channels-last input or an output not 16-byte aligned.
//
// Built by async_ev_cnn_torch/ops/cuda_build.py; bound with ctypes by
// async_ev_cnn_torch/ops/layer_norm.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileFloats = 8192;

__device__ __forceinline__ float warp_sum(float v) {
  for (int d = 16; d > 0; d >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

struct Map {
  long long s_frame, s_pixel, s_channel;  // the input's strides, in floats
  int hw, w, c, ph, pw, kind, norm;
  float eps;
};

// the output row of input token g (frame-major, then row-major pixels)
__device__ __forceinline__ uint32_t out_row(uint32_t g, const Map& m) {
  if (m.kind == 0) return g;
  const uint32_t f = g / m.hw, p = g - f * m.hw;
  const uint32_t i = p / m.w, j = p - i * m.w;
  const uint32_t h = m.hw / m.w, tiles_w = m.w / m.pw, part = m.ph * m.pw;
  uint32_t n, l;
  if (m.kind == 1) {  // window: ph x pw tiles
    n = (i / m.ph) * tiles_w + j / m.pw;
    l = (i % m.ph) * m.pw + j % m.pw;
  } else {  // grid: tokens h / ph rows and w / pw columns apart
    const uint32_t gh = h / m.ph;
    n = (i % gh) * tiles_w + j % tiles_w;
    l = (i / gh) * m.pw + j / tiles_w;
  }
  return (f * (m.hw / part) + n) * part + l;
}

// kChannelsFirst: the input's pixels are contiguous (a conv's NCHW map);
// else its channels are (channels-last), read four at a time.  Shared rows
// of ld floats: c + 1 for a channels-first load (its threads write one
// column, on distinct banks), c else.
template <bool kChannelsFirst>
__global__ void __launch_bounds__(kThreads)
    layer_norm_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, float* __restrict__ out, uint32_t rows,
                      const Map m) {
  extern __shared__ __align__(16) float tile[];
  const int ld = kChannelsFirst ? m.c + 1 : m.c;
  const int tile_rows = kTileFloats / ld;
  const uint32_t r0 = blockIdx.x * static_cast<uint32_t>(tile_rows);
  const int n_rows = static_cast<int>(min(rows - r0, static_cast<uint32_t>(tile_rows)));
  const int c4 = m.c / 4;
  if constexpr (kChannelsFirst) {
    const int n = n_rows * m.c;
#pragma unroll 4
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int r = e % n_rows, ch = e / n_rows;
      const uint32_t g = r0 + r, f = g / m.hw;
      tile[r * ld + ch] = __ldcs(x + f * m.s_frame + (g - f * m.hw) * m.s_pixel +
                                 ch * m.s_channel);
    }
  } else {
    const int n = n_rows * c4;
#pragma unroll 4
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int r = e / c4, ch = 4 * (e - r * c4);
      const uint32_t g = r0 + r, f = g / m.hw;
      *reinterpret_cast<float4*>(tile + r * ld + ch) = __ldcs(reinterpret_cast<const float4*>(
          x + f * m.s_frame + (g - f * m.hw) * m.s_pixel + ch));
    }
  }
  __syncthreads();
  if (m.norm) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const float inv_c = __fdiv_rn(1.0f, static_cast<float>(m.c));
    for (int r = warp; r < n_rows; r += kThreads / 32) {
      float* row = tile + r * ld;
      float s = 0.0f;
      for (int k = lane; k < m.c; k += 32) s = __fadd_rn(s, row[k]);
      const float mean = __fmul_rn(warp_sum(s), inv_c);
      float q = 0.0f;
      for (int k = lane; k < m.c; k += 32) {
        const float d = __fsub_rn(row[k], mean);
        q = __fadd_rn(q, __fmul_rn(d, d));
      }
      const float var = __fmul_rn(warp_sum(q), inv_c);
      const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, m.eps)));
      for (int k = lane; k < m.c; k += 32)
        row[k] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(row[k], mean), rstd), __ldg(gamma + k)),
                           __ldg(beta + k));
    }
    __syncthreads();
  }
  // four channels a thread; a row's output place found once for its c / 4
  const int n = n_rows * c4;
#pragma unroll 4
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / c4, ch = 4 * (e - r * c4);
    const float* src = tile + r * ld + ch;
    float* dst = out + static_cast<long long>(out_row(r0 + r, m)) * m.c + ch;
    if constexpr (kChannelsFirst)
      __stcs(reinterpret_cast<float4*>(dst), make_float4(src[0], src[1], src[2], src[3]));
    else
      __stcs(reinterpret_cast<float4*>(dst), *reinterpret_cast<const float4*>(src));
  }
}

}  // namespace

extern "C" int layer_norm(const float* x, const float* gamma, const float* beta, float* out,
                          long long rows, int h, int w, int c, long long s_frame,
                          long long s_pixel, long long s_channel, int kind, int ph, int pw,
                          int norm, float eps, cudaStream_t stream) {
  const bool channels_first = s_pixel == 1 && c > 1;
  if (rows < 1 || rows > 0x7fffffffLL || h < 1 || w < 1 || c < 4 || c % 4 || c > 512 ||
      rows % (static_cast<long long>(h) * w) || kind < 0 || kind > 2 ||
      (kind && (ph < 1 || pw < 1 || h % ph || w % pw)) || (!channels_first && s_channel != 1) ||
      (!channels_first && (s_frame % 4 || s_pixel % 4 || reinterpret_cast<uintptr_t>(x) % 16)) ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Map m{s_frame, s_pixel, s_channel, h * w, w, c, ph, pw, kind, norm, eps};
  const int ld = channels_first ? c + 1 : c;
  const int tile_rows = kTileFloats / ld;
  const unsigned blocks = static_cast<unsigned>((rows + tile_rows - 1) / tile_rows);
  const size_t smem = static_cast<size_t>(tile_rows) * ld * sizeof(float);
  if (channels_first)
    layer_norm_kernel<true><<<blocks, kThreads, smem, stream>>>(
        x, gamma, beta, out, static_cast<uint32_t>(rows), m);
  else
    layer_norm_kernel<false><<<blocks, kThreads, smem, stream>>>(
        x, gamma, beta, out, static_cast<uint32_t>(rows), m);
  return static_cast<int>(cudaGetLastError());
}
