// G1: the gate update of RVT's ConvLSTM for Hopper (sm_90a): one pass over
// a time step's gates in place of PyTorch's six.
//
// Replaces no Pallas kernel: the JAX package runs no recurrent layer.  Added
// because the update, eager, is six elementwise passes a step (two
// activations in place on strided halves of the gates, the cell's product
// and sum, its tanh and the output's product), 256 steps a 1,024-frame
// dispatch, about a tenth of the dispatch's device time.
//
// g: f32 [R, 4C] (R = streams x pixels, each row the forget, input and
// output gates' and the cell input's C pre-activations: the 1x1 conv over
// cat(x, h), RVT's split), c: f32 [R, C] in place, h: f32 [R, C] out:
//   f, i, o = sigmoid(g[:, :3C]) in thirds, z = tanh(g[:, 3C:]),
//   c = f * c + i * z,  h = o * tanh(c),
// sigmoid(v) = 1 / (1 + expf(-v)) and tanhf as PyTorch computes them,
// each operation rounded on its own (--fmad=false), so that the update is
// its plain version's (ops/lstm_gates.py) bit for bit where the two
// libraries' expf and tanhf agree.
//
// Bound: bytes.  Each row's gates are read once (16 C bytes), the cell read
// and written (8 C) and the hidden map written (4 C): 28 C bytes a pixel, at
// RVT-B 440 MB a stage-1 step of 16 streams, 52.8 GB a dispatch, 15.8 ms at
// 3.35 TB/s.  So four channels a thread: four 16-byte loads of the gates,
// one of the cell, two 16-byte stores (C % 4 == 0); consecutive threads on
// consecutive channels of a row; one launch a step, ceil(R C / 1024) blocks
// of 256 threads.  Elements count in 64 bits.
//
// Built by async_ev_cnn_torch/ops/cuda_build.py; bound with ctypes by
// async_ev_cnn_torch/ops/lstm_gates.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoid(float v) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
}

__device__ __forceinline__ void cell(float gf, float gi, float go, float gz, float& c, float& h) {
  c = __fadd_rn(__fmul_rn(sigmoid(gf), c), __fmul_rn(sigmoid(gi), tanhf(gz)));
  h = __fmul_rn(sigmoid(go), tanhf(c));
}

__global__ void __launch_bounds__(kThreads)
    lstm_gates_kernel(const float* __restrict__ g, float* __restrict__ c,
                      float* __restrict__ h, uint64_t items, uint32_t c4) {
  const uint64_t e = static_cast<uint64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= items) return;
  const uint64_t row = e / c4;
  const uint32_t k = static_cast<uint32_t>(e - row * c4);
  const float4* gr = reinterpret_cast<const float4*>(g) + row * 4 * c4 + k;
  const float4 f = __ldcs(gr), i = __ldcs(gr + c4), o = __ldcs(gr + 2 * c4),
               z = __ldcs(gr + 3 * c4);
  float4 cv = reinterpret_cast<const float4*>(c)[e];
  float4 hv;
  cell(f.x, i.x, o.x, z.x, cv.x, hv.x);
  cell(f.y, i.y, o.y, z.y, cv.y, hv.y);
  cell(f.z, i.z, o.z, z.z, cv.z, hv.z);
  cell(f.w, i.w, o.w, z.w, cv.w, hv.w);
  reinterpret_cast<float4*>(c)[e] = cv;
  __stcs(reinterpret_cast<float4*>(h) + e, hv);
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int lstm_gates(const float* g, float* c, float* h, long long rows, int channels,
                          cudaStream_t stream) {
  if (rows < 1 || channels < 4 || channels % 4 || !aligned(g) || !aligned(c) || !aligned(h))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t items = static_cast<uint64_t>(rows) * (channels / 4);
  const uint64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffULL) return static_cast<int>(cudaErrorInvalidValue);
  lstm_gates_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      g, c, h, items, static_cast<uint32_t>(channels / 4));
  return static_cast<int>(cudaGetLastError());
}
