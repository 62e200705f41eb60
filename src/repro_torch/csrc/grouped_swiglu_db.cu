// grouped_swiglu_db: per expert e, y = bf16(bf16(silu(x@wg)*(x@wu)) @ wd)
// over its occupied rows (below cnt[e]), rows past the count exact zeros;
// x (E, C, D), w_gate / w_up (E, D, F), w_down (E, F, D), y (E, C, D) bf16,
// flat (E,) counts only (the wrapper refuses bucketed counts, as the TPU
// kernel asserts at grouped_matmul.py:303).
//
// Replaces the TPU kernel repro/kernels/grouped_matmul.py:269
// grouped_swiglu_db_pallas (body _swiglu_db_kernel :229), which
// ops.grouped_swiglu selects under REPRO_SWIGLU_DB=1 for flat counts: the
// HT expert compute for an expert_fn without .fused (ep.py:359-366).
//
// Bound on an H100: at the HT prefill shape (64 experts, 128 rows each,
// ~4,000 occupied rows, D = 2048, F = 1408) the call reads every expert's
// three D x F matrices once, 1.1 GB: 0.33 ms at 3.35 TB/s, against
// 6 * D * F flops an occupied row (0.07 ms at 989 TF/s): bytes.
//
// Design.  The TPU kernel keeps token row blocks in HBM and copies them
// through two VMEM slots by hand, the next occupied block in flight while
// this one computes, so unoccupied blocks cost no reads.  Here a block
// owns one (expert, column tile) and walks the expert's occupied row tiles
// only, each over the reduction dim in 32-wide steps; the (row tile, step)
// sequence runs through a two-stage cp.async ring in shared memory: the
// copy of stage s + 1 (token and weight tiles; the next row tile's first
// step after this one's last) is issued before the MMAs of stage s, and
// waited for after them.  Row tiles at or past the count issue no copies;
// rows past it inside a tile are zero-filled by the copy (src-size 0).
// As in swiglu_tiles.cuh, the (bm, D) fp32 accumulator of the TPU kernel
// does not fit a block's shared memory, so two passes of one kernel run:
// kUp writes h = bf16(silu(gate) * up) (E*C, F), kDown y = h @ wd with
// exact zeros past the count.  bf16 WMMA (mma.sync) with fp32 sums; h
// rounds where the TPU kernel casts it (grouped_matmul.py:144).  Any C:
// ragged row tiles are masked by the count.  The reference's fallback to
// its pipelined kernel for a C without a divisor >= 8 (:282-287) is a TPU
// DMA-size constraint with no counterpart here.  D and F must be multiples
// of 8 (16-byte copies).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BM = 64;        // rows a tile
constexpr int BN = 64;        // output columns a block
constexpr int BK = 32;        // reduction step
constexpr int THREADS = 128;  // 4 warps, each a 32 x 32 quadrant
constexpr int STAGES = 2;
constexpr int APAD = 8, BPAD = 8, CPAD = 4;

enum Pass { kUp = 0, kDown = 1 };

struct Args {
  const bf16* a;    // (E*C, K): x (kUp) or h (kDown)
  const int* cnt;   // (E,)
  const bf16* w0;   // (E, K, N): w_gate (kUp) or w_down (kDown)
  const bf16* w1;   // (E, K, N): w_up (kUp)
  int C, K, N;
  bf16* out;        // (E*C, N): h (kUp) or y (kDown)
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

template <int PASS>
__global__ void __launch_bounds__(THREADS) db_kernel(Args p) {
  constexpr int NW = (PASS == kUp) ? 2 : 1;
  const int e = blockIdx.y;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int c = min(max(p.cnt[e], 0), p.C);
  const int n_tiles = (c + BM - 1) / BM;  // occupied row tiles
  const int nk = (p.K + BK - 1) / BK;
  const int ec = (tid & 7) * 8;           // epilogue: 8 columns, rows tid/8 + 16q
  const size_t row0 = (size_t)e * p.C;

  if (PASS == kDown && n0 + ec < p.N) {   // unoccupied row tiles: zeros, no reads
    for (int r = n_tiles * BM + (tid >> 3); r < p.C; r += THREADS / 8)
      *reinterpret_cast<uint4*>(p.out + (row0 + r) * p.N + n0 + ec) = make_uint4(0, 0, 0, 0);
  }
  if (n_tiles == 0) return;

  __shared__ __align__(128) bf16 As[STAGES][BM][BK + APAD];
  __shared__ __align__(128) bf16 Bs[STAGES][NW][BK][BN + BPAD];
  __shared__ __align__(128) float Cs[BM][BN + CPAD];

  const bf16* wb[NW];
  wb[0] = p.w0 + (size_t)e * p.K * p.N;
  if (NW == 2) wb[NW - 1] = p.w1 + (size_t)e * p.K * p.N;
  const int a_col = (tid & 3) * 8;  // A: rows tid/4 + 32i, 8 columns
  const int b_col = (tid & 7) * 8;  // B: reduce rows tid/8 + 16i, 8 columns

  // issue the copies of step s (row tile s / nk, reduce step s % nk)
  auto issue = [&](int s) {
    const int st = s & 1;
    const int m0 = (s / nk) * BM;
    const int k0 = (s % nk) * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (tid >> 2) + 32 * i;
      const int k = k0 + a_col;
      const bool ok = m0 + r < c && k < p.K;
      cp_async16(&As[st][r][a_col], ok ? p.a + (row0 + m0 + r) * p.K + k : p.a, ok);
    }
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kr = k0 + (tid >> 3) + 16 * i;
        const int n = n0 + b_col;
        const bool ok = kr < p.K && n < p.N;
        cp_async16(&Bs[st][w][(tid >> 3) + 16 * i][b_col],
                   ok ? wb[w] + (size_t)kr * p.N + n : wb[w], ok);
      }
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

  const int n_steps = n_tiles * nk;
  issue(0);
  cp_commit();
  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) issue(s + 1);  // in flight during this step's MMAs
    cp_commit();                         // (an empty group on the last step)
    cp_wait_one();                       // step s has landed
    __syncthreads();
    const int st = s & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &As[st][wm + 16 * i][kk], BK + APAD);
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, &Bs[st][w][kk][wn + 16 * j], BN + BPAD);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[w][i][j], fa[i], fb, acc[w][i][j]);
        }
    }
    if (s % nk == nk - 1) {  // the row tile is done: its epilogue
      const int m0 = (s / nk) * BM;
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
#pragma unroll
          for (int w = 0; w < NW; ++w) wmma::fill_fragment(acc[w][i][j], 0.0f);
        }
      __syncthreads();
      const int n = n0 + ec;
      if (n < p.N) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = (tid >> 3) + 16 * q;
          const int gr = m0 + r;
          // kUp leaves h's rows past the count unwritten: kDown never reads them
          if (gr >= (PASS == kUp ? c : p.C)) continue;
          __align__(16) bf16 v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = __float2bfloat16_rn(gr < c ? Cs[r][ec + u] : 0.0f);
          *reinterpret_cast<uint4*>(p.out + (row0 + gr) * p.N + n) =
              *reinterpret_cast<const uint4*>(v);
        }
      }
    }
    __syncthreads();  // stage s and Cs are free for step s + 2's copies
  }
}

}  // namespace

// x (E, C, D), w_gate / w_up (E, D, F), w_down (E, F, D) bf16, cnt (E,)
// int32, h (E*C, F) bf16 scratch, y (E, C, D) bf16; D, F multiples of 8.
extern "C" int grouped_swiglu_db_launch(const void* x, const void* cnt, const void* wg,
                                        const void* wu, const void* wd, void* h, void* y,
                                        int E, int C, int D, int F, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  Args up{};
  up.a = static_cast<const bf16*>(x);
  up.cnt = static_cast<const int*>(cnt);
  up.w0 = static_cast<const bf16*>(wg);
  up.w1 = static_cast<const bf16*>(wu);
  up.C = C;
  up.K = D;
  up.N = F;
  up.out = static_cast<bf16*>(h);
  db_kernel<kUp><<<dim3((F + BN - 1) / BN, E), THREADS, 0, s>>>(up);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  Args dn{};
  dn.a = static_cast<const bf16*>(h);
  dn.cnt = static_cast<const int*>(cnt);
  dn.w0 = static_cast<const bf16*>(wd);
  dn.C = C;
  dn.K = F;
  dn.N = D;
  dn.out = static_cast<bf16*>(y);
  db_kernel<kDown><<<dim3((D + BN - 1) / BN, E), THREADS, 0, s>>>(dn);
  return static_cast<int>(cudaGetLastError());
}
