// Rulebook gather-GEMM kernels for Hopper (sm_90a): the 'sparse_pallas'
// conv mode's update of the active output sites.
//
// Both kernels compute, for a list of output sites of a conv over the
// padded HWC featuremap and conv-actfn planes,
//
//     out_fm[site, o] = bias[o] + sum_{dy, dx, c} fm[y + dy, x + dx, c] * W[dy, dx, c, o]
//     out_ca[site, o] =           sum_{dy, dx, c} ca[y + dy, x + dx, c] * W[dy, dx, c, o]
//
// with (y, x) the site's receptive-field corner in the padded plane.  A
// site whose receptive field runs past the plane reads zeros there: the
// bounds check takes the place of the JAX package's padded copy.
//
//   * rulebook_gather_gemm_blocks (K3) replaces async_ev_cnn_tpu/ops/
//     pallas_rulebook_blocks.py::rulebook_gather_gemm_pallas_blocks
//     (_kernel): the sites come as x-aligned 1x8 blocks (by, bx), stride 1,
//     and one gathered [kh, 8 + kw - 1, C] strip feeds the 8 sites of a
//     block.
//   * rulebook_gather_gemm (K4) replaces async_ev_cnn_tpu/ops/
//     pallas_rulebook.py::rulebook_gather_gemm_pallas (_kernel): one site per entry (ys, xs)
//     with corner (ys * stride, xs * stride), any stride.
//
// One template serves both, with BW = 8 sites per gathered box (K3) or 1
// (K4).  A block owns kSites = 16 output sites (2 strips or 16 boxes) and
// kOTile = 32 output channels, one per lane, so the weight reads
// W[dy, dx, c, o] are coalesced across a warp; each of the 4 warps owns 4
// sites, and each thread keeps 4 sites x 2 planes of sums in registers.
// The boxes of both planes and the block's [kh, kw, c_chunk, 32] weight
// tile are staged in shared memory c_chunk channels at a time (the wrapper
// sizes c_chunk to keep the stage under 48 KB, so conv7's C = 512 fits),
// every thread loading its share with coalesced reads, so the products read
// shared memory only: all lanes of a warp read the same staged input value
// (a broadcast) and 32 consecutive weights (no bank conflict).
//
// Precision: the 'highest' tier is IEEE float32, so the products run on
// the FP32 pipe as explicit fmaf (FFMA; the file is built with
// --fmad=false, which leaves explicit fmaf calls alone), never on TF32
// tensor cores.  No snap fence lies inside: the sums run in another order
// than the JAX package's, within 1e-5 relative (chip_smoke.py and the tests
// state the tolerance).
//
// Bound: at the eFCN's shapes these kernels move little: the gathered
// boxes (K sites x kh x (8 + kw - 1) / 8 x C floats a plane) plus the
// weights, up to 1.18 MB at conv5, against 2 * 2 * K * 8 * kh * kw * C * O
// flops; both bounds are a few microseconds or less.  This simple design
// is far from them at the deep layers (conv4..conv7: few sites, a long
// kh * kw * C reduction): each thread runs its reduction serially and too
// few blocks fill the card.  Splitting the reduction, wgmma (3xTF32 at the
// 'highest' tier), TMA gathers and a fused scatter are later work.
//
// Built by async_ev_cnn_torch/ops/cuda_build.py; bound with ctypes by
// async_ev_cnn_torch/ops/rulebook_gemm.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kOTile = 32;           // output channels per block, one a lane
constexpr int kWarps = 4;
constexpr int kSitesPerThread = 4;   // sites per warp
constexpr int kSites = kWarps * kSitesPerThread;  // output sites per block

template <int BW>
__global__ void __launch_bounds__(kWarps * 32)
rulebook_kernel(const float* __restrict__ fm, const float* __restrict__ ca,
                const float* __restrict__ w, const float* __restrict__ bias,
                const int32_t* __restrict__ ys, const int32_t* __restrict__ xs,
                float* __restrict__ out_fm, float* __restrict__ out_ca,
                int k_len, int hp, int wp, int c_len, int o_len, int kh, int kw,
                int stride, int c_chunk) {
  constexpr int kBoxes = kSites / BW;  // gathered boxes per block
  extern __shared__ float smem[];
  __shared__ int y0s[kBoxes];
  __shared__ int x0s[kBoxes];
  __shared__ bool live_box[kBoxes];

  const int box_w = (BW - 1) * stride + kw;
  const int box = kh * box_w * c_chunk;  // floats of one box of one plane
  float* s_fm = smem;
  float* s_ca = smem + kBoxes * box;
  float* s_w = s_ca + kBoxes * box;      // [kh * kw, c_chunk, kOTile]

  const int box0 = blockIdx.x * kBoxes;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int o = blockIdx.y * kOTile + lane;
  const bool o_live = o < o_len;

  if (threadIdx.x < kBoxes) {
    const int b = box0 + threadIdx.x;
    const bool live = b < k_len;
    // K3: by in sites, bx in strips of BW sites (stride 1);
    // K4: the site's corner is (ys * stride, xs * stride)
    y0s[threadIdx.x] = live ? ys[b] * stride : 0;
    x0s[threadIdx.x] = live ? xs[b] * BW * stride : 0;
    live_box[threadIdx.x] = live;
  }

  float acc_fm[kSitesPerThread];
  float acc_ca[kSitesPerThread];
  const float b0 = o_live ? bias[o] : 0.0f;
#pragma unroll
  for (int r = 0; r < kSitesPerThread; ++r) {
    acc_fm[r] = b0;
    acc_ca[r] = 0.0f;
  }
  // this thread's sites: box and offset of each inside the staged boxes
  int site_off[kSitesPerThread];
#pragma unroll
  for (int r = 0; r < kSitesPerThread; ++r) {
    const int t = warp * kSitesPerThread + r;
    site_off[r] = (t / BW) * box + (t % BW) * stride * c_chunk;
  }

  for (int c0 = 0; c0 < c_len; c0 += c_chunk) {
    const int cc = min(c_chunk, c_len - c0);
    __syncthreads();  // corners written; the previous chunk fully used
    const int per_box = kh * box_w * cc;
    for (int i = threadIdx.x; i < kBoxes * per_box; i += blockDim.x) {
      const int b = i / per_box;
      const int rem = i - b * per_box;
      const int ch = rem % cc;
      const int px = rem / cc;
      const int col = px % box_w;
      const int row = px / box_w;
      const int y = y0s[b] + row;
      const int x = x0s[b] + col;
      float vf = 0.0f, vc = 0.0f;
      if (live_box[b] && y >= 0 && y < hp && x >= 0 && x < wp) {
        const size_t at = (static_cast<size_t>(y) * wp + x) * c_len + c0 + ch;
        vf = fm[at];
        vc = ca[at];
      }
      const int dst = b * box + (row * box_w + col) * c_chunk + ch;
      s_fm[dst] = vf;
      s_ca[dst] = vc;
    }
    // the weight tile: consecutive threads read consecutive output channels
    const int o0 = blockIdx.y * kOTile;
    for (int i = threadIdx.x; i < kh * kw * cc * kOTile; i += blockDim.x) {
      const int oo = i % kOTile;
      const int tc = i / kOTile;  // tap * cc + ch
      const int tap = tc / cc;
      const int ch = tc - tap * cc;
      s_w[(tap * c_chunk + ch) * kOTile + oo] =
          o0 + oo < o_len
              ? w[(static_cast<size_t>(tap) * c_len + c0 + ch) * o_len + o0 + oo]
              : 0.0f;
    }
    __syncthreads();
    if (o_live) {
      for (int dy = 0; dy < kh; ++dy) {
        for (int dx = 0; dx < kw; ++dx) {
          const float* w_tap = s_w + (dy * kw + dx) * c_chunk * kOTile + lane;
          const int tap = (dy * box_w + dx) * c_chunk;
          for (int ch = 0; ch < cc; ++ch) {
            const float wv = w_tap[ch * kOTile];
#pragma unroll
            for (int r = 0; r < kSitesPerThread; ++r) {
              const int at = site_off[r] + tap + ch;
              acc_fm[r] = fmaf(s_fm[at], wv, acc_fm[r]);
              acc_ca[r] = fmaf(s_ca[at], wv, acc_ca[r]);
            }
          }
        }
      }
    }
  }

  if (!o_live) return;
#pragma unroll
  for (int r = 0; r < kSitesPerThread; ++r) {
    const int t = warp * kSitesPerThread + r;
    const int b = box0 + t / BW;
    if (b < k_len) {
      const size_t at = (static_cast<size_t>(b) * BW + t % BW) * o_len + o;
      out_fm[at] = acc_fm[r];
      out_ca[at] = acc_ca[r];
    }
  }
}

template <int BW>
int launch(const float* fm, const float* ca, const float* w, const float* bias,
           const int32_t* ys, const int32_t* xs, float* out_fm, float* out_ca,
           int k_len, int hp, int wp, int c_len, int o_len, int kh, int kw,
           int stride, int c_chunk, cudaStream_t stream) {
  constexpr int kBoxes = kSites / BW;
  const int box_w = (BW - 1) * stride + kw;
  const size_t smem = sizeof(float) * c_chunk *
                      (2 * kBoxes * kh * box_w + kh * kw * kOTile);
  const dim3 grid((k_len + kBoxes - 1) / kBoxes, (o_len + kOTile - 1) / kOTile);
  rulebook_kernel<BW><<<grid, kWarps * 32, smem, stream>>>(
      fm, ca, w, bias, ys, xs, out_fm, out_ca, k_len, hp, wp, c_len, o_len, kh,
      kw, stride, c_chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes.  Each launches its kernel once and
// returns cudaGetLastError() (0 = success).  Pointers are device pointers;
// the stream is the caller's current stream.  fm, ca: f32 [hp, wp, c_len];
// w: f32 [kh, kw, c_len, o_len]; bias: f32 [o_len]; ys, xs: int32 [k_len];
// out_fm, out_ca: f32 [k_len, BW, o_len].  The caller never passes k_len,
// c_len or o_len of 0, and sizes c_chunk so the stage fits in 48 KB.

extern "C" int rulebook_gather_gemm_blocks(
    const float* fm, const float* ca, const float* w, const float* bias,
    const int32_t* by, const int32_t* bx, float* out_fm, float* out_ca,
    int k_len, int hp, int wp, int c_len, int o_len, int kh, int kw,
    int c_chunk, cudaStream_t stream) {
  return launch<8>(fm, ca, w, bias, by, bx, out_fm, out_ca, k_len, hp, wp,
                   c_len, o_len, kh, kw, 1, c_chunk, stream);
}

extern "C" int rulebook_gather_gemm(
    const float* fm, const float* ca, const float* w, const float* bias,
    const int32_t* ys, const int32_t* xs, float* out_fm, float* out_ca,
    int k_len, int hp, int wp, int c_len, int o_len, int kh, int kw,
    int stride, int c_chunk, cudaStream_t stream) {
  return launch<1>(fm, ca, w, bias, ys, xs, out_fm, out_ca, k_len, hp, wp,
                   c_len, o_len, kh, kw, stride, c_chunk, stream);
}
