// Fused eFCN stem (K6) for Hopper (sm_90a): maxpool2x2(leaky(conv3x3_SAME(x) + b))
// for a one-channel input, in one kernel.
//
// Replaces examples/pallas_stem_negative.py::fused_stem (_stem_kernel), a
// measured alternative to the library stem that the JAX package keeps
// beside it (not on its path).  x: f32 [T, H, W] (H, W even); w: f32
// [9, O] taps, dy-major; bias: f32 [O] -> out: f32 [T, O, H/2, W/2].
//
// The direct stem writes the [T, O, H, W] conv output to device memory and
// reads it back for the pool (459 MB each way at T=200, 160x224, O=16);
// this kernel keeps it on chip.  One block per (frame, band of kBand
// pooled rows): the block stages the band's 2 * kBand input rows plus a
// one-pixel zero halo, and the taps and bias, in shared memory.  Each
// thread then owns one pooled pixel at a time: it reads the 4x4 input
// patch under its 2x2 window into registers once, and for every output
// channel computes the 4 conv values, the activation, the max and one
// store; consecutive threads store consecutive columns (coalesced).
//
// Arithmetic, as the TPU kernel orders it (its :46-50): acc = b[o], then
// acc += x * w tap by tap, dy-major, each product and sum rounded
// separately (__fmul_rn / __fadd_rn, and --fmad=false), then
// where(acc > 0, acc, alpha * acc), then the 2x2 max.  The plain version
// in ops/fused_stem.py runs the same operations as separate float32 ops,
// so the two agree bit for bit.
//
// Bound: at T=200, 160x224, O=16 it must read 28.7 MB and write 114.7 MB
// (42.8 us at 3.35 TB/s) and run 1.03e9 multiply-adds (31 us of FP32
// FFMA at 67 TFLOP/s): bytes bound it.
//
// Built by async_ev_cnn_torch/ops/cuda_build.py; bound with ctypes by
// async_ev_cnn_torch/ops/fused_stem.py.

#include <cuda_runtime.h>

namespace {

constexpr int kBand = 8;       // pooled rows per block
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fused_stem_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int h, int wd, int o_len, float alpha) {
  extern __shared__ float smem[];
  const int sw = wd + 2;                 // staged width with the halo
  const int rows = 2 * kBand + 2;        // staged rows with the halo
  float* s_x = smem;                     // [rows, sw]
  float* s_w = smem + rows * sw;         // [9, o_len]
  float* s_b = s_w + 9 * o_len;          // [o_len]

  const int t = blockIdx.y;
  const int hp = h / 2, wp = wd / 2;
  const int py0 = blockIdx.x * kBand;
  const int y_in0 = 2 * py0 - 1;         // input row of staged row 0
  const float* frame = x + static_cast<size_t>(t) * h * wd;

  for (int i = threadIdx.x; i < rows * sw; i += blockDim.x) {
    const int yy = i / sw;
    const int xx = i - yy * sw;
    const int y = y_in0 + yy;
    const int xi = xx - 1;
    s_x[i] = (y >= 0 && y < h && xi >= 0 && xi < wd)
                 ? frame[static_cast<size_t>(y) * wd + xi]
                 : 0.0f;
  }
  for (int i = threadIdx.x; i < 9 * o_len; i += blockDim.x) s_w[i] = w[i];
  for (int i = threadIdx.x; i < o_len; i += blockDim.x) s_b[i] = bias[i];
  __syncthreads();

  const int band_rows = min(kBand, hp - py0);
  for (int p = threadIdx.x; p < band_rows * wp; p += blockDim.x) {
    const int pr = p / wp;   // pooled row within the band
    const int px = p - pr * wp;
    // the 4x4 input patch under the 2x2 window: staged rows 2*pr .. 2*pr+3,
    // staged columns 2*px .. 2*px+3
    float v[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) v[a][b] = s_x[(2 * pr + a) * sw + 2 * px + b];
    }
    float* dst = out + ((static_cast<size_t>(t) * o_len) * hp + py0 + pr) * wp + px;
    for (int o = 0; o < o_len; ++o) {
      float m = 0.0f;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          float acc = s_b[o];
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              acc = __fadd_rn(acc, __fmul_rn(v[a + dy][b + dx], s_w[(dy * 3 + dx) * o_len + o]));
            }
          }
          acc = acc > 0.0f ? acc : __fmul_rn(alpha, acc);
          m = (a == 0 && b == 0) ? acc : fmaxf(m, acc);
        }
      }
      dst[static_cast<size_t>(o) * hp * wp] = m;
    }
  }
}

}  // namespace

// C interface, bound with ctypes; returns cudaGetLastError() (0 = success).
// x: f32 [t_len, h, wd] (h, wd even); w: f32 [9, o_len]; bias: f32 [o_len];
// out: f32 [t_len, o_len, h / 2, wd / 2].  The caller never passes a t_len
// or o_len of 0, and keeps the stage within the shared memory it asks for.
extern "C" int fused_stem(const float* x, const float* w, const float* bias,
                          float* out, int t_len, int h, int wd, int o_len,
                          float alpha, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((2 * kBand + 2) * (wd + 2) + 10 * o_len);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((h / 2 + kBand - 1) / kBand, t_len);
  fused_stem_kernel<<<grid, kThreads, smem, stream>>>(x, w, bias, out, h, wd,
                                                      o_len, alpha);
  return static_cast<int>(cudaGetLastError());
}
