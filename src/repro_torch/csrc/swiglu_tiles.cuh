// Shared tile kernel of the two grouped-SwiGLU kernels (grouped_swiglu.cu,
// gather_swiglu_scatter.cu).
//
// The TPU kernels keep a (bm, D) fp32 accumulator in VMEM and stream the
// hidden dim F through it.  At D = 2048 and bm = 128 that is 1 MB, far over
// the 227 KB of shared memory a Hopper block can use, so the work is split
// into two passes over one tile kernel:
//
//   (a) kUp:   h = bf16(silu(x @ w_gate) * (x @ w_up))     tiles over (rows, F)
//   (b) kDown: y = h @ w_down, fp32 accumulate               tiles over (rows, D)
//
// h rounds to bf16 between the passes exactly where the TPU kernel casts it
// to x.dtype (grouped_matmul.py:144).  A block owns one BM x BN output tile
// of one group and loops over the reduction dim in BK steps: A rows (tokens,
// optionally gathered through a row table) and the weight tile go through
// shared memory, bf16 WMMA (mma.sync) accumulates in fp32, and the next
// step's global loads are issued into registers before the current step's
// MMAs so their latency overlaps.  Row tiles at or past the group's count do
// no loads and no MMAs; rows past the count inside an occupied tile load as
// zeros.  Pass (b) writes exact zeros to its output rows past the count
// (kDownStore) or adds nothing for them (kDownScatter); pass (a) leaves
// those rows of the scratch h unwritten, since pass (b) never reads them.
//
// Bound on an H100: at decode the occupied groups hold a handful of rows, so
// both passes are bound by reading each occupied expert's weights once
// (3 * D * F * 2 bytes); at prefill a group holds up to ~128 rows and the
// work nears the bf16 tensor-core rate.  This first version is plain
// mma.sync without TMA/wgmma pipelining; its times stand in PERF.md.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace swiglu_tiles {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BM = 64;        // rows per block tile
constexpr int BN = 64;        // output columns per block tile
constexpr int BK = 32;        // reduction step
constexpr int THREADS = 128;  // 4 warps, each a 32 x 32 quadrant
constexpr int APAD = 8, BPAD = 8, CPAD = 4;

enum Epilogue { kUp = 0, kDownStore = 1, kDownScatter = 2 };

struct Args {
  const bf16* a;       // A table: x / x_ext (kUp) or h (kDown*)
  const int* a_rows;   // nullable gather table, indexed g * Cg + r
  int a_nrows;         // rows in A's table (gathered indices are clamped)
  const int* cnt;      // (G,) occupied-prefix row counts
  const bf16* w0;      // (E, K, N) weights, expert = g / B
  const bf16* w1;      // second (E, K, N) weights for kUp (w_up)
  int Cg, B, K, N;     // rows per group, sub-buckets per expert, reduce, cols
  bf16* out_bf16;      // kUp: h (G*Cg, N);  kDownStore: y (G*Cg, N)
  float* out_f32;      // kDownScatter: (s_nrows, N) fp32, atomically added
  const int* s_rows;   // kDownScatter: token row per slot
  const float* s_w;    // kDownScatter: combine weight per slot
  int s_nrows;
};

template <int EPI>
__global__ void __launch_bounds__(THREADS) tile_kernel(Args p) {
  constexpr int NW = (EPI == kUp) ? 2 : 1;
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int c = min(max(p.cnt[g], 0), p.Cg);
  const int ec = (tid & 7) * 8;  // epilogue: 8 columns, rows tid/8 + 16q

  if (m0 >= c) {  // unoccupied tile: no weight reads, no MMAs
    if (EPI == kDownStore) {
      const int n = n0 + ec;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int gr = m0 + (tid >> 3) + 16 * q;
        if (gr < p.Cg && n < p.N)
          *reinterpret_cast<uint4*>(p.out_bf16 + ((size_t)g * p.Cg + gr) * p.N + n) =
              make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }

  __shared__ __align__(128) bf16 As[BM][BK + APAD];
  __shared__ __align__(128) bf16 Bs[NW][BK][BN + BPAD];
  __shared__ __align__(128) float Cs[BM][BN + CPAD];

  // A: rows tid/4 and tid/4 + 32, 8 columns at (tid % 4) * 8
  const int a_col = (tid & 3) * 8;
  const bf16* a_ptr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = m0 + (tid >> 2) + 32 * i;
    a_ptr[i] = nullptr;
    if (gr < c) {
      long row = (long)g * p.Cg + gr;
      if (p.a_rows) row = min(max(p.a_rows[row], 0), p.a_nrows - 1);
      a_ptr[i] = p.a + (size_t)row * p.K;
    }
  }
  // B: reduce rows tid/8 and tid/8 + 16, 8 columns at (tid % 8) * 8
  const int b_col = (tid & 7) * 8;
  const size_t e = (size_t)(g / p.B);
  const bf16* wb[NW];
  wb[0] = p.w0 + e * p.K * p.N;
  if (NW == 2) wb[NW - 1] = p.w1 + e * p.K * p.N;

  uint4 ra[2], rb[NW][2];
  const uint4 zero = make_uint4(0, 0, 0, 0);
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = k0 + a_col;
      ra[i] = (a_ptr[i] && k < p.K) ? *reinterpret_cast<const uint4*>(a_ptr[i] + k) : zero;
    }
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kr = k0 + (tid >> 3) + 16 * i;
        const int n = n0 + b_col;
        rb[w][i] = (kr < p.K && n < p.N)
                       ? *reinterpret_cast<const uint4*>(wb[w] + (size_t)kr * p.N + n)
                       : zero;
      }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint4*>(&As[(tid >> 2) + 32 * i][a_col]) = ra[i];
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint4*>(&Bs[w][(tid >> 3) + 16 * i][b_col]) = rb[w][i];
  };

  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NW][2][2];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[w][i][j], 0.0f);

  const int nk = (p.K + BK - 1) / BK;
  load(0);
  store();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) * BK);  // in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &As[wm + 16 * i][kk], BK + APAD);
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, &Bs[w][kk][wn + 16 * j], BN + BPAD);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[w][i][j], fa[i], fb, acc[w][i][j]);
        }
    }
    __syncthreads();
    if (kt + 1 < nk) {
      store();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (NW == 2) {
        // gate and up fragments share one element layout
#pragma unroll
        for (int t = 0; t < acc[0][i][j].num_elements; ++t) {
          const float gv = acc[0][i][j].x[t];
          const float uv = acc[NW - 1][i][j].x[t];
          acc[0][i][j].x[t] = gv * (1.0f / (1.0f + expf(-gv))) * uv;
        }
      }
      wmma::store_matrix_sync(&Cs[wm + 16 * i][wn + 16 * j], acc[0][i][j], BN + CPAD,
                              wmma::mem_row_major);
    }
  __syncthreads();

  const int n = n0 + ec;
  if (n >= p.N) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = (tid >> 3) + 16 * q;
    const int gr = m0 + r;
    if (EPI == kUp || EPI == kDownStore) {
      if (gr >= (EPI == kUp ? c : p.Cg)) continue;
      __align__(16) bf16 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = __float2bfloat16_rn(gr < c ? Cs[r][ec + u] : 0.0f);
      *reinterpret_cast<uint4*>(p.out_bf16 + ((size_t)g * p.Cg + gr) * p.N + n) =
          *reinterpret_cast<const uint4*>(v);
    } else {
      if (gr >= c) continue;
      const size_t s = (size_t)g * p.Cg + gr;
      const int tok = p.s_rows[s];
      if (tok < 0 || tok >= p.s_nrows) continue;
      const float wv = p.s_w[s];
      float* dst = p.out_f32 + (size_t)tok * p.N + n;
#pragma unroll
      for (int u = 0; u < 8; ++u) atomicAdd(dst + u, wv * Cs[r][ec + u]);
    }
  }
}

inline dim3 grid_for(int n_cols, int rows_per_group, int groups) {
  return dim3((n_cols + BN - 1) / BN, (rows_per_group + BM - 1) / BM, groups);
}

}  // namespace swiglu_tiles
