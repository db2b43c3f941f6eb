// Tiled, split-reduction gather-GEMM for Hopper (sm_90a): the 'sparse_pallas'
// conv mode's update of active 1x8 site blocks (K3) and of single active
// sites at any stride (K4), and the conv of whole active output rows (K5).
//
// All three compute, for a list of M output sites of a conv over the
// padded HWC featuremap and conv-actfn planes,
//
//     out_fm[s, o] = bias[o] + sum_{dy, dx, c} fm[y(s) + dy, x(s) + dx, c] * W[dy, dx, c, o]
//     out_ca[s, o] =           sum_{dy, dx, c} ca[y(s) + dy, x(s) + dx, c] * W[dy, dx, c, o]
//
// with (y(s), x(s)) the site's receptive-field corner; reads outside the
// padded plane are zero (the JAX package pads the planes instead).
//
//   * K3 replaces async_ev_cnn_tpu/ops/pallas_rulebook_blocks.py::
//     rulebook_gather_gemm_pallas_blocks (_kernel): site (b, s) of block b
//     has corner (by[b], 8 * bx[b] + s), out [K, 8, O].
//   * K4 replaces async_ev_cnn_tpu/ops/pallas_rulebook.py::
//     rulebook_gather_gemm_pallas (_kernel): site s has corner
//     (ys[s] * stride, xs[s] * stride), out [K, O].
//   * K5 replaces async_ev_cnn_tpu/ops/pallas_rows.py::
//     rows_gather_conv_pallas (_kernel): site (r, x), x < ow, has corner
//     (rows[r], x), out [R, ow, O].
//
// The site-to-corner map (SiteMap, a template argument) is the only
// difference, and it is read once per block, never in the inner loop.  The
// rest is an implicit GEMM: M is the sites of both planes, N = O, and the
// reduction is kh * kw * C in HWIO order, so W is a row-major
// [kh * kw * C, O] matrix and, for each dy, one site's (dx, c) run is
// kw * C contiguous floats of the HWC plane at every stride.
//
// Design, against what holds a gather-GEMM of few sites and long
// reductions back on 132 SMs (too few blocks, a shared-memory load per
// FFMA, a serial reduction a thread):
//
//   * A block owns a BS-site x BN-channel tile of both planes (2 * BS GEMM
//     rows), so both planes' rows of a site share every staged weight
//     slice.  Each thread keeps a 4 x 4 tile of sums in registers (two
//     sites x two planes x four channels) as an outer product: per 4-deep
//     step it reads 4 float4 of A and 4 float4 of W from shared memory and
//     issues 64 FFMA.  Wide: 32 sites x 64 channels, 256 threads, BK 32;
//     narrow (O <= 16, conv1): 64 sites x 16 channels, 128 threads, BK 16.
//   * Each BK-deep reduction slice of the gathered A rows and of W goes
//     through a two-stage cp.async ring: slice i+1's copies are in flight
//     while slice i is multiplied.  16-byte copies where C % 4 == 0 (A) and
//     O % 4 == 0 (W), 4-byte copies otherwise (conv1's C = 1, conv7's
//     O = 110); an out-of-plane read is the zero-fill form (source size
//     0).  The site corners are computed once per block into shared
//     memory; the loader divides once per slice, not per element.
//   * Where the site x channel tiles are fewer than two blocks per SM, the
//     wrapper's plan splits the slices over blockIdx.z: each split writes
//     its partial sums to a [S, 2, M, O] workspace and split_sum_kernel
//     adds them in a fixed order (s = 0, 1, ...) and adds the bias.  No
//     atomics: the same inputs give bit-equal outputs on every launch.
//
// Precision: every product is an explicit fmaf (FFMA; the file is built
// with --fmad=false, which leaves explicit fmaf calls alone), never a
// tensor-core op.  At 'highest' and 'high' the operands are used as they
// are (IEEE float32).  At 'default' (TF32 = true, a template argument)
// each thread rounds the operands it staged with cvt.rna.tf32.f32 once its
// copies land, and the sums stay float32: a TF32 x TF32 product is exact
// in float32, so only the summation order differs from the plain version
// (within 1e-5 relative; chip_smoke.py and the tests state the tolerance).
//
// Bound: at the eFCN's shapes these calls move little (the gathered
// planes, W and the outputs: at most about 1.2 MB) against 2 * 2 * M * O *
// kh * kw * C flops; both bounds are a few microseconds or less, so launch
// latency and the deep layers' long reductions over few sites set the
// time.  Tensor cores (wgmma TF32, 3xTF32 at 'highest') are later work.
//
// Built by async_ev_cnn_torch/ops/cuda_build.py; bound with ctypes and
// planned by async_ev_cnn_torch/ops/rulebook_gemm.py (gather_gemm_plan).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// BS sites (2 * BS GEMM rows) x BN channels a block, BK-deep slices
template <int BS_, int BN_, int BK_, int THREADS_>
struct Tile {
  static constexpr int BS = BS_;
  static constexpr int BN = BN_;
  static constexpr int BK = BK_;
  static constexpr int THREADS = THREADS_;
  static constexpr int TN = BN / 4;             // threads across channels
  static constexpr int TM = THREADS / TN;       // threads across rows
  static constexpr int RPT = 2 * BS / TM;       // rows a thread: 4
  static constexpr int LDA = BK + 4;            // padded A row, 16-byte aligned
  static constexpr int A_FLOATS = 2 * BS * LDA; // [plane, site, k]
  static constexpr int STAGE = A_FLOATS + BK * BN;
  static_assert(RPT == 4 && TM * 2 == BS, "a thread holds two sites of both planes");
  static_assert(THREADS % BK == 0 && THREADS % BN == 0, "loader index pattern");
};

using Narrow = Tile<64, 16, 16, 128>;  // tile 0: O <= 16
using Wide = Tile<32, 64, 32, 256>;    // tile 1

// float32 -> TF32 (10 mantissa bits), to nearest, ties away from zero
__device__ __forceinline__ float to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void round_tf32_4(float* p) {
  float4 v = *reinterpret_cast<float4*>(p);
  v.x = to_tf32(v.x);
  v.y = to_tf32(v.y);
  v.z = to_tf32(v.z);
  v.w = to_tf32(v.w);
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; the bytes past src_bytes (0 or all) are zeros
__device__ __forceinline__ void copy16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes) : "memory");
}

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

struct Geometry {
  int m_sites, hp, wpc, c_len, o_len, kwc, k_total, ow, stride;
};

// where a site's receptive field starts (see the file comment)
enum class SiteMap { kBlocks = 0, kRows = 1, kSites = 2 };

// One slice's A rows of both planes (ROUND = false: issue the copies;
// ROUND = true: round to TF32 the elements this thread copied, same
// pattern).  y0s[s] is the site's first input row (hp when the site is
// past M), x0c[s] its first column times C.
template <class T, bool ROUND>
__device__ __forceinline__ void stage_a(float* as, const float* __restrict__ fm,
                                        const float* __restrict__ ca, const int* y0s,
                                        const int* x0c, int k0, const Geometry& g,
                                        bool a_vec) {
  if (a_vec) {  // C % 4 == 0: a 4-group never leaves one (dy, dx) run
    constexpr int KG = T::BK / 4;
    const int q = threadIdx.x % KG;
    const int k = k0 + 4 * q;
    const int dy = k / g.kwc;
    const int rem = k - dy * g.kwc;
    for (int s = threadIdx.x / KG; s < T::BS; s += T::THREADS / KG) {
      float* d = as + s * T::LDA + 4 * q;
      if (ROUND) {
        round_tf32_4(d);
        round_tf32_4(d + T::BS * T::LDA);
        continue;
      }
      const int y = y0s[s] + dy;
      const int xo = x0c[s] + rem;
      const bool ok = k < g.k_total && static_cast<unsigned>(y) < static_cast<unsigned>(g.hp) &&
                      static_cast<unsigned>(xo) < static_cast<unsigned>(g.wpc);
      const size_t off = ok ? static_cast<size_t>(y) * g.wpc + xo : 0;
      copy16(d, fm + off, ok ? 16 : 0);
      copy16(d + T::BS * T::LDA, ca + off, ok ? 16 : 0);
    }
  } else {
    const int kk = threadIdx.x % T::BK;
    const int k = k0 + kk;
    const int dy = k / g.kwc;
    const int rem = k - dy * g.kwc;
    for (int s = threadIdx.x / T::BK; s < T::BS; s += T::THREADS / T::BK) {
      float* d = as + s * T::LDA + kk;
      if (ROUND) {
        d[0] = to_tf32(d[0]);
        d[T::BS * T::LDA] = to_tf32(d[T::BS * T::LDA]);
        continue;
      }
      const int y = y0s[s] + dy;
      const int xo = x0c[s] + rem;
      const bool ok = k < g.k_total && static_cast<unsigned>(y) < static_cast<unsigned>(g.hp) &&
                      static_cast<unsigned>(xo) < static_cast<unsigned>(g.wpc);
      const size_t off = ok ? static_cast<size_t>(y) * g.wpc + xo : 0;
      copy4(d, fm + off, ok ? 4 : 0);
      copy4(d + T::BS * T::LDA, ca + off, ok ? 4 : 0);
    }
  }
}

// One slice's [BK, BN] weight tile, as stage_a
template <class T, bool ROUND>
__device__ __forceinline__ void stage_w(float* ws, const float* __restrict__ w, int k0, int n0,
                                        const Geometry& g, bool w_vec) {
  if (w_vec) {  // O % 4 == 0
    constexpr int NG = T::BN / 4;
    const int q = threadIdx.x % NG;
    const int n = n0 + 4 * q;
    for (int kk = threadIdx.x / NG; kk < T::BK; kk += T::THREADS / NG) {
      float* d = ws + kk * T::BN + 4 * q;
      if (ROUND) {
        round_tf32_4(d);
        continue;
      }
      const bool ok = k0 + kk < g.k_total && n < g.o_len;
      copy16(d, w + (ok ? static_cast<size_t>(k0 + kk) * g.o_len + n : 0), ok ? 16 : 0);
    }
  } else {
    const int col = threadIdx.x % T::BN;
    const int n = n0 + col;
    for (int kk = threadIdx.x / T::BN; kk < T::BK; kk += T::THREADS / T::BN) {
      float* d = ws + kk * T::BN + col;
      if (ROUND) {
        d[0] = to_tf32(d[0]);
        continue;
      }
      const bool ok = k0 + kk < g.k_total && n < g.o_len;
      copy4(d, w + (ok ? static_cast<size_t>(k0 + kk) * g.o_len + n : 0), ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ float lane(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// MAP: K3's block map (ys = by, xs = bx), K5's row map (ys = rows, xs
// unused, ow columns a row) or K4's site map (ys, xs, stride)
template <class T, SiteMap MAP, bool TF32>
__global__ void __launch_bounds__(T::THREADS, 2)
gather_gemm_kernel(const float* __restrict__ fm, const float* __restrict__ ca,
                   const float* __restrict__ w, const float* __restrict__ bias,
                   const int32_t* __restrict__ ys, const int32_t* __restrict__ xs,
                   float* __restrict__ out_fm, float* __restrict__ out_ca,
                   float* __restrict__ partial, Geometry g, int n_slices, int a_vec,
                   int w_vec) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int y0s[T::BS];
  __shared__ int x0c[T::BS];

  const int m0 = blockIdx.x * T::BS;
  const int n0 = blockIdx.y * T::BN;
  const int tn = threadIdx.x % T::TN;
  const int tm = threadIdx.x / T::TN;

  if (threadIdx.x < T::BS) {
    const int site = m0 + threadIdx.x;
    int y = g.hp, x = 0;  // a site past M reads zeros and is never written
    if (site < g.m_sites) {
      if (MAP == SiteMap::kRows) {
        const int r = site / g.ow;
        y = ys[r];
        x = site - r * g.ow;
      } else if (MAP == SiteMap::kBlocks) {
        y = ys[site >> 3];
        x = xs[site >> 3] * 8 + (site & 7);
      } else {
        y = ys[site] * g.stride;
        x = xs[site] * g.stride;
      }
    }
    y0s[threadIdx.x] = y;
    x0c[threadIdx.x] = x * g.c_len;
  }
  __syncthreads();

  // this split's slices: [z * n / S, (z + 1) * n / S), never empty (S <= n)
  const int s_begin = blockIdx.z * n_slices / gridDim.z;
  const int s_end = (blockIdx.z + 1) * n_slices / gridDim.z;

  float acc[T::RPT][4];
#pragma unroll
  for (int i = 0; i < T::RPT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  auto stage = [&](int buf, int slice) {
    float* as = smem + buf * T::STAGE;
    stage_a<T, false>(as, fm, ca, y0s, x0c, slice * T::BK, g, a_vec);
    stage_w<T, false>(as + T::A_FLOATS, w, slice * T::BK, n0, g, w_vec);
    copy_commit();
  };

  stage(0, s_begin);
  for (int s = s_begin; s < s_end; ++s) {
    const int buf = (s - s_begin) & 1;
    if (s + 1 < s_end) {
      stage(buf ^ 1, s + 1);  // in flight while this slice is multiplied
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    float* as = smem + buf * T::STAGE;
    const float* wsm = as + T::A_FLOATS;
    if (TF32) {  // this thread's own copies have landed: round them
      stage_a<T, true>(as, fm, ca, y0s, x0c, s * T::BK, g, a_vec);
      stage_w<T, true>(as + T::A_FLOATS, w, s * T::BK, n0, g, w_vec);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < T::BK; kk += 4) {
      float4 a[T::RPT];
#pragma unroll
      for (int i = 0; i < T::RPT; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + (tm + T::TM * i) * T::LDA + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(wsm + (kk + j) * T::BN + 4 * tn);
#pragma unroll
        for (int i = 0; i < T::RPT; ++i) {
          const float av = lane(a[i], j);
          acc[i][0] = fmaf(av, b.x, acc[i][0]);
          acc[i][1] = fmaf(av, b.y, acc[i][1]);
          acc[i][2] = fmaf(av, b.z, acc[i][2]);
          acc[i][3] = fmaf(av, b.w, acc[i][3]);
        }
      }
    }
    __syncthreads();  // the buffer is free for the slice after next
  }

  // rows tm + TM * i: i = 0, 1 the featuremap plane, i = 2, 3 conv-actfn
  const bool split = gridDim.z > 1;
  const int n = n0 + 4 * tn;
  const bool vec_out = (g.o_len & 3) == 0 && n + 3 < g.o_len;
#pragma unroll
  for (int i = 0; i < T::RPT; ++i) {
    const int plane = i / 2;
    const int site = m0 + tm + T::TM * (i % 2);
    if (site >= g.m_sites) continue;
    const size_t row = split ? (static_cast<size_t>(blockIdx.z) * 2 + plane) * g.m_sites + site
                             : static_cast<size_t>(site);
    float* dst = (split ? partial : plane ? out_ca : out_fm) + row * g.o_len;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = !split && plane == 0 && n + j < g.o_len ? bias[n + j] + acc[i][j] : acc[i][j];
    if (vec_out) {
      *reinterpret_cast<float4*>(dst + n) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < g.o_len) dst[n + j] = v[j];
    }
  }
}

// out = bias + sum_s partial[s] (featuremap plane), sum_s partial[s]
// (conv-actfn), the splits added in order s = 0, 1, ...
__global__ void split_sum_kernel(const float* __restrict__ partial,
                                 const float* __restrict__ bias, float* __restrict__ out_fm,
                                 float* __restrict__ out_ca, int plane_len, int o_len,
                                 int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * plane_len) return;
  const size_t stride = 2 * static_cast<size_t>(plane_len);
  float s = partial[i];
  for (int z = 1; z < splits; ++z) s += partial[z * stride + i];
  if (i < plane_len)
    out_fm[i] = bias[i % o_len] + s;
  else
    out_ca[i - plane_len] = s;
}

// the device pointers of one call
struct Operands {
  const float *fm, *ca, *w, *bias;
  const int32_t *ys, *xs;
  float *out_fm, *out_ca, *partial;
};

// the caller's plan
struct Plan {
  int grid_x, grid_y, splits, smem_bytes, a_vec, w_vec;
};

template <class T, SiteMap MAP, bool TF32>
int launch(const Operands& a, const Geometry& g, const Plan& p, cudaStream_t stream) {
  constexpr int kSmem = 2 * T::STAGE * static_cast<int>(sizeof(float));
  const int n_slices = (g.k_total + T::BK - 1) / T::BK;
  // the caller's plan must be this instance's: same stage, every site and
  // channel covered, 1 <= S <= the number of slices
  if (p.smem_bytes != kSmem || static_cast<long long>(p.grid_x) * T::BS < g.m_sites ||
      p.grid_y * T::BN < g.o_len || p.splits < 1 || p.splits > n_slices)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gather_gemm_kernel<T, MAP, TF32>;
  if (kSmem > 48 * 1024) {  // above the default limit: opt in, once per instance
    static const cudaError_t opt_in =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  }
  kernel<<<dim3(p.grid_x, p.grid_y, p.splits), T::THREADS, kSmem, stream>>>(
      a.fm, a.ca, a.w, a.bias, a.ys, a.xs, a.out_fm, a.out_ca, a.partial, g, n_slices,
      p.a_vec, p.w_vec);
  if (p.splits > 1) {
    const int plane_len = g.m_sites * g.o_len;
    split_sum_kernel<<<(2 * plane_len + 255) / 256, 256, 0, stream>>>(
        a.partial, a.bias, a.out_fm, a.out_ca, plane_len, g.o_len, p.splits);
  }
  return static_cast<int>(cudaGetLastError());
}

// the tile and the tier are template arguments: the 'highest' code carries
// no branch
template <SiteMap MAP>
int launch_map(int tile, int tf32, const Operands& a, const Geometry& g, const Plan& p,
               cudaStream_t stream) {
  if (tile == 0)
    return (tf32 ? launch<Narrow, MAP, true> : launch<Narrow, MAP, false>)(a, g, p, stream);
  if (tile == 1)
    return (tf32 ? launch<Wide, MAP, true> : launch<Wide, MAP, false>)(a, g, p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C interface, bound with ctypes.  Launches the gather-GEMM once, and the
// split pass after it when splits > 1; returns cudaGetLastError() (0 =
// success).  Pointers are device pointers, the stream the caller's current
// stream.  fm, ca: f32 [hp, wp, c_len]; w: f32 [kh, kw, c_len, o_len];
// bias: f32 [o_len]; out_fm, out_ca: f32 [m_sites, o_len].
//   site_map 0 (K3): ys = by, xs = bx, int32 [m_sites / 8];
//   site_map 1 (K5): ys = rows, int32 [m_sites / ow], xs unused;
//   site_map 2 (K4): ys, xs, int32 [m_sites], corners at stride.
// tile 0 is the narrow instance, 1 the wide one; grid_x, grid_y, splits and
// smem_bytes come from the plan (ops/rulebook_gemm.gather_gemm_plan) and
// are checked against the instance.  partial: f32 [splits, 2, m_sites,
// o_len] when splits > 1.  a_vec / w_vec: 1 when c_len / o_len is a
// multiple of 4 and the planes / w are 16-byte aligned (16-byte copies).
// tf32: 1 rounds both operands to TF32 (the 'default' tier).
extern "C" int gather_gemm(const float* fm, const float* ca, const float* w,
                           const float* bias, const int32_t* ys, const int32_t* xs,
                           float* out_fm, float* out_ca, float* partial, int m_sites, int hp,
                           int wp, int c_len, int o_len, int kh, int kw, int ow, int stride,
                           int site_map, int tile, int grid_x, int grid_y, int splits,
                           int smem_bytes, int a_vec, int w_vec, int tf32,
                           cudaStream_t stream) {
  const Operands a{fm, ca, w, bias, ys, xs, out_fm, out_ca, partial};
  const Geometry g{m_sites, hp, wp * c_len, c_len, o_len, kw * c_len, kh * kw * c_len, ow,
                   stride};
  const Plan p{grid_x, grid_y, splits, smem_bytes, a_vec, w_vec};
  switch (site_map) {
    case 0:
      return launch_map<SiteMap::kBlocks>(tile, tf32, a, g, p, stream);
    case 1:
      return launch_map<SiteMap::kRows>(tile, tf32, a, g, p, stream);
    case 2:
      return launch_map<SiteMap::kSites>(tile, tf32, a, g, p, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
