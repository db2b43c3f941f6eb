// Conv epilogue for Hopper (sm_90a): the bias, the leaky activation and, for a
// conv that a 2x2 stride-2 max-pool follows, that pool, over a cuDNN conv's raw
// output in one pass.
//
// Replaces no Pallas kernel: the JAX package leaves this fusion to XLA, which
// folds the bias, the activation and reduce_window into the conv's output
// fusion.  Eagerly the same work is seven passes over each conv output (the
// bias add 2, x * alpha 2, the maximum 3) and the pool's read of the
// activated map.
//
// x: f32 [P, H, W] (P planes of C channels each, the conv's output without
// its bias), bias: f32 [C], plane p taking bias[p % C];
//   pooled:   out [P, H/2, W/2] = act(max(x[p, 2i:2i+2, 2j:2j+2]) + bias)
//             (VALID: an odd last row or column is left out);
//   unpooled: out [P, H, W]     = act(x + bias);
// act(v) = max(v, v * alpha), by a max that passes NaN through, as
// torch.maximum and F.max_pool2d do.  out is f32, or bf16 rounded to nearest
// even as Tensor.to(torch.bfloat16) rounds (a template parameter).
// The SiLU form (silu = 1, unpooled only: SiLU is not monotone) gives
// act(v) = v / (1 + expf(-v)), F.silu's arithmetic, for YOLOX's convs.
//
// Exact, not close: for 0 < alpha <= 1, v -> fl(v + b), v -> max(v, fl(v *
// alpha)) and the rounding to bf16 are each nondecreasing (round to nearest
// is monotone, also at the infinities), so the activation of a window's max
// is the max of its activations, value for value (a zero's sign aside).
// The entry refuses to pool for any other alpha (alpha = 0 is left out:
// -inf * 0 is NaN).  The bias is still one rounded add after cuDNN's sum,
// and --fmad=false leaves v * alpha a rounded product.
//
// Bound: bytes.  Nothing is reused: each raw output is read once and each
// result written once.  On the eFCN at N = 1,024 frames, 4.64 GB read and
// 1.23 GB written a dispatch: 1.75 ms at 3.35 TB/s.  So:
//   * one thread a pair of pooling windows: a 16-byte load from each of
//     its two rows, where W % 4 == 0 and the planes are 16-byte aligned
//     (conv1-conv4 of the eFCN, 95% of its bytes), and one 8-byte store
//     (4 bytes in bf16); one window and 8-byte loads where W % 2 == 0
//     only (conv5's 14-float rows: every other row is not 16-byte
//     aligned); scalar loads where W is odd;
//   * the unpooled pass takes four elements a thread, one 16-byte load
//     where the count and the pointers allow, four scalar loads else,
//     each element its own channel (conv6 and conv7's 5x7 planes are 35
//     floats: a vector may cross two planes);
//   * the loads stream (ld.global.cs: evict first, nothing is read again);
//     consecutive threads take consecutive windows of one plane, so a
//     warp's bias reads fall on one or two channels, served from L1;
//   * one item a thread, ceil(items / 256) blocks, no shared memory: 2,048
//     threads an SM with 32 bytes each in flight cover the memory's latency.
// The choice of load width is the shape's and the pointers' (the entry's).
// One launch takes the whole tensor: an item covers at least four input
// elements, so below 2^34 elements (64 GiB, more than an 80 GB card holds
// beside the output) the items count in 32 bits; offsets into the tensor
// are 64-bit.  The entry refuses a larger tensor, and a plane of 2^32
// elements or more.
//
// Built by async_ev_cnn_torch/ops/cuda_build.py; bound with ctypes by
// async_ev_cnn_torch/ops/epilogue.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float act(float v, float b, float alpha) {
  v = __fadd_rn(v, b);
  return max_nan(v, __fmul_rn(v, alpha));
}

__device__ __forceinline__ float silu(float v, float b) {
  v = __fadd_rn(v, b);
  return __fdiv_rn(v, __fadd_rn(1.0f, expf(-v)));
}

// the unpooled pass's activation: leaky, or SiLU (alpha unused)
template <bool kSilu>
__device__ __forceinline__ float act_of(float v, float b, float alpha) {
  if constexpr (kSilu) return silu(v, b);
  return act(v, b, alpha);
}

// float -> bf16 bits, to nearest even, NaN to the quiet NaN (c10::BFloat16's rule)
__device__ __forceinline__ uint16_t bf16_bits(float v) {
  if (v != v) return 0x7fc0u;
  const uint32_t u = __float_as_uint(v);
  return static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

struct Bf16 {
  uint16_t bits;
};

__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(Bf16* p, float a) {
  *reinterpret_cast<uint16_t*>(p) = bf16_bits(a);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(Bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = bf16_bits(a) | static_cast<uint32_t>(bf16_bits(b)) << 16;
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(Bf16* p, float a, float b, float c, float d) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bf16_bits(a) | static_cast<uint32_t>(bf16_bits(b)) << 16,
                 bf16_bits(c) | static_cast<uint32_t>(bf16_bits(d)) << 16);
}

__device__ __forceinline__ float max4(float a, float b, float c, float d) {
  return max_nan(max_nan(a, b), max_nan(c, d));
}

// kVec floats a load: 4 (two windows a thread), 2 (one window), 1 (one
// window, scalar loads).  An item is a thread's window or pair of windows.
template <int kVec, typename Out>
__global__ void __launch_bounds__(kThreads)
    pool_epilogue_kernel(const float* __restrict__ x, const float* __restrict__ bias,
                         Out* __restrict__ out, uint32_t items, uint32_t groups, uint32_t ho,
                         uint32_t channels, uint32_t h, uint32_t wd, uint32_t wo, float alpha) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= items) return;
  const uint32_t q = t % groups;   // the item's place in its pooled row
  const uint32_t row = t / groups;  // plane * ho + pooled row
  const uint32_t plane = row / ho;
  const uint32_t i = row - plane * ho;
  const float b = __ldg(bias + plane % channels);
  constexpr uint32_t kCols = kVec == 4 ? 4 : 2;  // input columns an item reads a row
  const float* top = x + (static_cast<uint64_t>(plane) * h + 2 * i) * wd + q * kCols;
  const float* bot = top + wd;
  Out* dst = out + static_cast<uint64_t>(row) * wo + q * (kCols / 2);
  if constexpr (kVec == 4) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(top));
    const float4 c = __ldcs(reinterpret_cast<const float4*>(bot));
    store2(dst, act(max4(a.x, a.y, c.x, c.y), b, alpha), act(max4(a.z, a.w, c.z, c.w), b, alpha));
  } else if constexpr (kVec == 2) {
    const float2 a = __ldcs(reinterpret_cast<const float2*>(top));
    const float2 c = __ldcs(reinterpret_cast<const float2*>(bot));
    store1(dst, act(max4(a.x, a.y, c.x, c.y), b, alpha));
  } else {
    store1(dst, act(max4(__ldcs(top), __ldcs(top + 1), __ldcs(bot), __ldcs(bot + 1)), b, alpha));
  }
}

// four consecutive elements a thread, of n: one 16-byte load (kVector) or
// four scalar loads, the last item cut at n
template <bool kVector, bool kSilu, typename Out>
__global__ void __launch_bounds__(kThreads)
    act_epilogue_kernel(const float* __restrict__ x, const float* __restrict__ bias,
                        Out* __restrict__ out, uint64_t n, uint32_t plane_size,
                        uint32_t channels, float alpha) {
  const uint64_t e = 4 * static_cast<uint64_t>(blockIdx.x * kThreads + threadIdx.x);
  if (e >= n) return;
  const uint64_t plane = e / plane_size;
  uint32_t r = static_cast<uint32_t>(e - plane * plane_size);  // place in the plane
  uint32_t ch = static_cast<uint32_t>(plane % channels);
  float b[4];
  for (int k = 0; k < 4; ++k) {
    if (k > 0 && ++r == plane_size) {  // into the next plane
      r = 0;
      ch = ch + 1 == channels ? 0 : ch + 1;
    }
    b[k] = __ldg(bias + ch);
  }
  if constexpr (kVector) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(x + e));
    store4(out + e, act_of<kSilu>(v.x, b[0], alpha), act_of<kSilu>(v.y, b[1], alpha),
           act_of<kSilu>(v.z, b[2], alpha), act_of<kSilu>(v.w, b[3], alpha));
  } else {
    for (int k = 0; k < 4 && e + k < n; ++k)
      store1(out + e + k, act_of<kSilu>(__ldcs(x + e + k), b[k], alpha));
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

uint32_t blocks(uint32_t items) { return items / kThreads + (items % kThreads != 0); }

template <bool kSilu, typename Out>
void launch_act(const float* x, const float* bias, Out* out, uint64_t n, uint32_t plane_size,
                uint32_t channels, float alpha, cudaStream_t stream) {
  const uint32_t items = static_cast<uint32_t>((n + 3) / 4);
  if (n % 4 == 0 && aligned(x, 16) && aligned(out, 4 * sizeof(Out))) {
    act_epilogue_kernel<true, kSilu, Out><<<blocks(items), kThreads, 0, stream>>>(
        x, bias, out, n, plane_size, channels, alpha);
  } else {
    act_epilogue_kernel<false, kSilu, Out><<<blocks(items), kThreads, 0, stream>>>(
        x, bias, out, n, plane_size, channels, alpha);
  }
}

template <typename Out>
int launch(const float* x, const float* bias, Out* out, uint64_t planes, uint32_t channels,
           uint32_t h, uint32_t wd, float alpha, bool pooled, bool silu,
           cudaStream_t stream) {
  if (pooled) {
    const uint32_t ho = h / 2, wo = wd / 2;
    if (ho == 0 || wo == 0) return static_cast<int>(cudaSuccess);
    const uint32_t rows = static_cast<uint32_t>(planes * ho);
    if (wd % 4 == 0 && aligned(x, 16) && aligned(out, 2 * sizeof(Out))) {
      const uint32_t items = rows * (wd / 4);
      pool_epilogue_kernel<4, Out><<<blocks(items), kThreads, 0, stream>>>(
          x, bias, out, items, wd / 4, ho, channels, h, wd, wo, alpha);
    } else if (wd % 2 == 0 && aligned(x, 8)) {
      const uint32_t items = rows * wo;
      pool_epilogue_kernel<2, Out><<<blocks(items), kThreads, 0, stream>>>(
          x, bias, out, items, wo, ho, channels, h, wd, wo, alpha);
    } else {
      const uint32_t items = rows * wo;
      pool_epilogue_kernel<1, Out><<<blocks(items), kThreads, 0, stream>>>(
          x, bias, out, items, wo, ho, channels, h, wd, wo, alpha);
    }
  } else if (silu) {
    launch_act<true>(x, bias, out, planes * h * wd, h * wd, channels, alpha, stream);
  } else {
    launch_act<false>(x, bias, out, planes * h * wd, h * wd, channels, alpha, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int conv_epilogue(const float* x, const float* bias, void* out, long long planes,
                             int channels, int h, int wd, float alpha, int pooled,
                             int out_bf16, int silu, cudaStream_t stream) {
  if (planes < 1 || channels < 1 || planes % channels != 0 || h < 1 || wd < 1 ||
      static_cast<long long>(h) * wd > 0xffffffffLL ||
      planes * h * wd > (1LL << 34) - 4 || (pooled && !(alpha > 0.0f && alpha <= 1.0f)) ||
      (pooled && silu))
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_bf16)
    return launch(x, bias, static_cast<Bf16*>(out), planes, channels, h, wd, alpha,
                  pooled != 0, silu != 0, stream);
  return launch(x, bias, static_cast<float*>(out), planes, channels, h, wd, alpha,
                pooled != 0, silu != 0, stream);
}
