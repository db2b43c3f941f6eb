// Gather-copy microbenchmark (K7) for Hopper (sm_90a): device memory ->
// shared memory copies in the geometries of the rulebook gathers.
//
// Replaces examples/dma_microbench.py::run (_kernel), the TPU's HBM->VMEM
// DMA probe.  Grid step i issues n_copies copies; copy t of step i has
// index j = i * n_copies + t and reads, from src [H, W, C] f32 (or its
// flattened view), with the example's address formulas:
//
//   flat     flat[off : off + kh * WCOPY * C], off = ((j * 37) % n_blk) * 1024
//   box      src[y0 : y0 + kh, x0 : x0 + WCOPY, :], y0 = (j * 7) % (H - kh),
//            x0 = (j * 13) % (W - WCOPY)
//   rows     the same kh rows, each issued as a copy group of its own
//   box_sp   box at (ys[j % n_sites], xs[j % n_sites]) (data-dependent)
//   rows_sp  rows at the same data-dependent corners
//   box_sm   src[y0 : y0 + kh, x0 : x0 + 8, :] (4 KB rows)
//
// Each copy is 16-byte cp.async.cg requests (L2 only, not L1) from every
// thread of its block, committed as one group (kh groups for rows), then
// waited for.  Step i's first copy holds src[y0, x0, :] (flat[off : off +
// C] for flat) in its first C floats, which the example adds into its
// output: here the block of copy 0 writes them to row i of a [grid, C]
// buffer, and sum_rows adds the rows up in grid order, so the result
// equals the plain version's ordered sum bit for bit (float additions do
// not reassociate).
//
// One block carries one copy, not one grid step: a step's 8 copies of up
// to 128 KB (kh = 8) cannot sit in one block's 227 KB of shared memory at
// once, as they sit in a TPU core's VMEM.  The grid holds grid * n_copies
// blocks, and the slope between two grids (scripts/dma_microbench.py) is
// the same per-copy cost.  TMA copies are later work.
//
// Bound: the copies' bytes over 3.35 TB/s (the source, 171 MB, is larger
// than the 50 MB L2, but the data-dependent corners of box_sp / rows_sp
// revisit 16384 sites and may hit in L2).
//
// Built by async_ev_cnn_torch/ops/cuda_build.py; bound with ctypes by
// async_ev_cnn_torch/scripts/dma_microbench.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWCopy = 32;   // columns of a box or row copy
constexpr int kWSmall = 8;   // columns of a box_sm copy

enum Shape { kFlat = 0, kBox = 1, kRows = 2, kBoxSp = 3, kRowsSp = 4, kBoxSm = 5 };

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// copy n floats (a multiple of 4) from src to dst, 16 bytes a request
__device__ __forceinline__ void copy_span(float* dst, const float* src, int n) {
  for (int k = threadIdx.x * 4; k < n; k += kThreads * 4) copy16(dst + k, src + k);
}

__global__ void __launch_bounds__(kThreads)
gather_copy_kernel(const float* __restrict__ src, const float* __restrict__ flat,
                   const int32_t* __restrict__ ys, const int32_t* __restrict__ xs,
                   float* __restrict__ rows_out, int h, int w, int c, int n_sites,
                   int n_copies, int shape, int kh) {
  extern __shared__ __align__(16) float scratch[];
  const int i = blockIdx.x / n_copies;
  const int t = blockIdx.x - i * n_copies;
  const int j = i * n_copies + t;

  if (shape == kFlat) {
    const int sz = kh * kWCopy * c;
    const long long n_blk = (static_cast<long long>(h) * w * c - sz) / 1024;
    const long long off = ((static_cast<long long>(j) * 37) % n_blk) * 1024;
    copy_span(scratch, flat + off, sz);
    commit();
  } else {
    int y0, x0;
    if (shape == kBoxSp || shape == kRowsSp) {
      const int jj = j % n_sites;
      y0 = ys[jj];
      x0 = xs[jj];
    } else {
      y0 = (j * 7) % (h - kh);
      x0 = (j * 13) % (w - kWCopy);
    }
    const int cols = shape == kBoxSm ? kWSmall : kWCopy;
    const int row = cols * c;  // floats of one row of the copy
    for (int r = 0; r < kh; ++r) {
      copy_span(scratch + r * row,
                src + (static_cast<size_t>(y0 + r) * w + x0) * c, row);
      if (shape == kRows || shape == kRowsSp) commit();  // one group a row
    }
    if (!(shape == kRows || shape == kRowsSp)) commit();  // one group a box
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  // consume the first C floats of copy 0, so the copies cannot be elided
  if (t == 0) {
    for (int k = threadIdx.x; k < c; k += kThreads)
      rows_out[static_cast<size_t>(i) * c + k] = scratch[k];
  }
}

// out[k] = sum over i, in order, of rows[i, k]
__global__ void sum_rows_kernel(const float* __restrict__ rows, float* __restrict__ out,
                                int grid, int c) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= c) return;
  float acc = 0.0f;
  for (int i = 0; i < grid; ++i) acc = __fadd_rn(acc, rows[static_cast<size_t>(i) * c + k]);
  out[k] = acc;
}

}  // namespace

// C interface, bound with ctypes; returns cudaGetLastError() (0 = success).
// src, flat: f32 [h, w, c] and its flattened view; ys, xs: int32 [n_sites];
// rows_out: f32 [grid, c] scratch; out: f32 [c].  shape: 0 flat, 1 box,
// 2 rows, 3 box_sp, 4 rows_sp, 5 box_sm.  The caller checks that every
// copy lies inside src and that c is a multiple of 4.
extern "C" int gather_copy(const float* src, const float* flat, const int32_t* ys,
                           const int32_t* xs, float* rows_out, float* out, int h,
                           int w, int c, int n_sites, int grid, int n_copies,
                           int shape, int kh, cudaStream_t stream) {
  const int cols = shape == kBoxSm ? kWSmall : kWCopy;
  const int smem = static_cast<int>(sizeof(float)) * kh * cols * c;
  cudaError_t err = cudaFuncSetAttribute(
      gather_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_copy_kernel<<<grid * n_copies, kThreads, smem, stream>>>(
      src, flat, ys, xs, rows_out, h, w, c, n_sites, n_copies, shape, kh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_rows_kernel<<<(c + 127) / 128, 128, 0, stream>>>(rows_out, out, grid, c);
  return static_cast<int>(cudaGetLastError());
}
