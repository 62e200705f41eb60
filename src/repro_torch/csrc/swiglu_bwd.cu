// Backward kernels of the expert SwiGLU: grouped_swiglu_bwd (the gradient
// of grouped_swiglu over (E, C, D) buffers, LL) and gather_swiglu_scatter_bwd
// (the gradient of the fused gather -> SwiGLU -> weighted scatter-add, HT).
//
// The TPU package has no backward kernels: its training differentiates the
// jnp oracles of repro/kernels/grouped_matmul.py:179 grouped_swiglu_pallas
// and :368 gather_swiglu_scatter_pallas (kernels/ref.py grouped_swiglu_ref,
// gather_swiglu_scatter_ref) with jax.grad.  These kernels compute the same
// gradients on the card.  For one expert e with occupied rows X (n x D,
// bf16), weights Wg, Wu (D x F), Wd (F x D) and upstream rows DY (n x D):
//
//   G = X Wg, U = X Wu (fp32 sums), A = silu(G), H = bf16(A * U)  recomputed
//   DHu = bf16(DY) Wd^T (fp32), DH = w * DHu
//   DU = bf16(DH * A), DG = bf16(DH * U * s(G) * (1 + G * (1 - s(G))))
//   dX = DG Wg^T + DU Wu^T              fp32; HT adds it into the token row
//                                       the slot gathered (fp32 atomics), LL
//                                       stores it (bf16, zero rows past the
//                                       counts)
//   dWg = X^T DG, dWu = X^T DU, dWd = H^T bf16(w * DY)   fp32 sums, bf16 out
//   HT: dw[s] = sum_f DHu[s, f] H[s, f] = <DY[s], y_s>, the slot weight's
//   gradient (y_s = H Wd, the slot's fp32 expert output)
//
// In LL the upstream is the bf16 gradient of the bf16 output and w = 1; in
// HT it is the fp32 gradient of the (T, D) fp32 output, gathered through
// src (rows at or past T, the scratch row, read as zeros), and w the slot's
// combine weight.  The plain versions (kernels/grouped_matmul.py
// *_bwd_plain) round at the same points.
//
// Bound on an H100: operations.  16 D F flops an occupied row (the gate and
// up products recomputed, 4 D F; the five gradient products, 12 D F) on the
// bf16 tensor cores: at qwen2-moe's HT training step (16,384 occupied rows,
// D 2048, F 1408) 0.76 TFLOP, 0.76 ms at 989 TFLOP/s, beside 2.2 GB of
// weights read and their gradients written (0.66 ms).
//
// Design, a first simple kernel: four passes of mma.sync.m16n8k16 (bf16 in,
// fp32 accumulate) in 256-thread blocks.  Each operand tile comes from
// device memory through registers into padded shared memory (conflict-free
// ldmatrix rows; .trans where the operand's contiguous dimension is the
// product's M or N); the next step's loads are in flight while this step's
// products run.
//   (a) up:      rows x F tiles (128 x 64): G, U and DHu, then H, DG, DU into
//                bf16 scratch (E*C, F), and the slot weights' gradient
//                (fp32 atomics over the F tiles);
//   (b) dx:      rows x D tiles (128 x 128): dX over K = F twice;
//   (c) dw_up:   per expert, D x F tiles (128 x 64) of dWg and dWu;
//   (d) dw_down: per expert, F x D tiles (128 x 128) of dWd;
// (c) and (d) reduce over each sub-bucket's occupied prefix in 32-row steps
// and store every expert's tiles (zeros for an expert without rows).
// Row tiles of (a) and (b) with no occupied row load nothing.  Nothing
// saved from the forward is read: the backward recomputes G and U, so a
// layer recomputed under checkpoint costs its forward launch again and no
// memory between the passes.  The wgmma/TMA tile loop of the forwards
// (swiglu_tiles.cuh) is the later redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps: 4 down the rows, 2 across
constexpr int BK = 32;         // reduction step
constexpr int kPad = 8;        // bf16 elements of padding a shared row

// ------------------------------------------------------------- helpers --
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// This lane's address for an x4 ldmatrix of the 16 x 16 block at (row0,
// col0) of a shared tile: matrix i = lane / 8 takes rows 8 (i % 2) and
// columns 8 (i / 2) on (ROWS_FIRST), else rows 8 (i / 2), columns 8 (i % 2).
// An A operand stored [m][k] and a B operand stored [k][n] (read .trans)
// go rows first; A stored [k][m] (.trans) and B stored [n][k] columns first:
// either way the registers come out in mma.sync's fragment order.
template <bool ROWS_FIRST>
__device__ __forceinline__ const bf16* frag(const bf16* tile, int stride, int row0, int col0) {
  const int lane = threadIdx.x % 32, i = lane / 8;
  const int ro = ROWS_FIRST ? 8 * (i % 2) : 8 * (i / 2);
  const int co = ROWS_FIRST ? 8 * (i / 2) : 8 * (i % 2);
  return tile + (row0 + lane % 8 + ro) * stride + col0 + co;
}

// One k16 step of a warp's MI x NJ grid of m16n8 products: A from sA (rows
// m, [m][k] unless A_KM: [k][m]), B from sB ([n][k] unless B_KN: [k][n])
template <int MI, int NJ, bool A_KM, bool B_KN>
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NJ][4], const bf16* sA, int sa,
                                         int m0, const bf16* sB, int sb, int n0, int kk) {
  uint32_t a[MI][4], b[NJ / 2][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    if (A_KM)
      ldsm4t(a[mi], frag<false>(sA, sa, kk, m0 + 16 * mi));
    else
      ldsm4(a[mi], frag<true>(sA, sa, m0 + 16 * mi, kk));
  }
#pragma unroll
  for (int p = 0; p < NJ / 2; ++p) {
    if (B_KN)
      ldsm4t(b[p], frag<true>(sB, sb, kk, n0 + 16 * p));
    else
      ldsm4(b[p], frag<false>(sB, sb, n0 + 16 * p, kk));
  }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
      mma(acc[mi][nj], a[mi], b[nj / 2][2 * (nj % 2)], b[nj / 2][2 * (nj % 2) + 1]);
}

// 8 elements of a tile on their way from device memory to shared memory,
// held in registers while the step before them computes
template <typename T> struct Chunk;
template <> struct Chunk<bf16> {
  uint4 v;
  __device__ __forceinline__ void fetch(const bf16* p, float) {
    v = p ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ uint4 bits() const { return v; }
};
template <> struct Chunk<float> {  // fp32 rows, scaled and rounded to bf16
  float4 a, b;
  float s;
  __device__ __forceinline__ void fetch(const float* p, float scale) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    a = p ? __ldg(reinterpret_cast<const float4*>(p)) : z;
    b = p ? __ldg(reinterpret_cast<const float4*>(p) + 1) : z;
    s = scale;
  }
  __device__ __forceinline__ uint4 bits() const {
    return make_uint4(pack2(a.x * s, a.y * s), pack2(a.z * s, a.w * s),
                      pack2(b.x * s, b.y * s), pack2(b.z * s, b.w * s));
  }
};

// A thread's share of an R x W tile in 8-element chunks: chunk c (this
// thread's i-th is c = tid + 256 i) is row c / (W / 8), columns 8 (c % (W / 8))
template <int R, int W> struct Tile {
  static constexpr int kStride = W + kPad;
  static constexpr int kChunks = R * W / 8 / kThreads;
  static_assert(R * W / 8 % kThreads == 0, "whole chunks a thread");
  __device__ static int row(int i) { return (threadIdx.x + i * kThreads) / (W / 8); }
  __device__ static int col(int i) { return (threadIdx.x + i * kThreads) % (W / 8) * 8; }
  template <typename T>
  __device__ static void store(bf16* s, const Chunk<T> (&c)[kChunks]) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i)
      *reinterpret_cast<uint4*>(s + row(i) * kStride + col(i)) = c[i].bits();
  }
};

// ------------------------------------------------------------ the call --
// Rows of a row-major (nrows, ld) table: slot s reads row gather[s] (the
// slot itself without a gather), scaled by scale[s] (fp32 rows; 1 without);
// a row outside the table reads as zeros unless ``clamp`` moves it inside,
// as the forward gathers
template <typename T>
struct Rows {
  const T* base;
  const int* gather;
  const float* scale;
  long long ld;
  int nrows;
  int clamp;
  __device__ __forceinline__ int index(int slot) const {
    const int r = gather ? gather[slot] : slot;
    return clamp ? min(max(r, 0), nrows - 1) : r;
  }
  __device__ __forceinline__ const T* row(int slot, float& s) const {
    const int r = index(slot);
    s = scale ? scale[slot] : 1.f;
    return (r < 0 || r >= nrows) ? nullptr : base + (size_t)r * ld;
  }
};

struct Args {
  const int* cnt;    // (E * B,) occupied prefix of each sub-bucket (clamped to Cg)
  int E, C, B, Cg;   // experts; rows an expert = B sub-buckets of Cg
  int D, F;
  Rows<bf16> x;      // token rows by slot (HT: gathered, clamped)
  Rows<bf16> dy16;   // LL: the upstream rows by slot
  Rows<float> dy32;  // HT: the upstream rows by slot (no scale)
  const float* w;    // HT: the slots' combine weights
  const bf16 *wg, *wu, *wd;
  bf16 *h, *dg, *du;  // scratch (E * C, F)
  float* dw;          // HT: (E * C,) zeroed
  float* dx32;        // HT: (x.nrows, D) zeroed, atomically added
  bf16* dx16;         // LL: (E * C, D)
  bf16 *dwg, *dwu, *dwd;
};

__device__ __forceinline__ bool occupied(const Args& p, int e, int r) {
  if (r < 0 || r >= p.C) return false;
  const int b = r / p.Cg;
  return r - b * p.Cg < p.cnt[e * p.B + b];
}

// the upstream row of a slot: HT's fp32 rows, or LL's bf16 ones
template <bool HT> struct Up;
template <> struct Up<true> {
  using T = float;
  __device__ static const float* row(const Args& p, int slot, float& s) {
    return p.dy32.row(slot, s);
  }
};
template <> struct Up<false> {
  using T = bf16;
  __device__ static const bf16* row(const Args& p, int slot, float& s) {
    return p.dy16.row(slot, s);
  }
};

// the occupied rows of expert e in steps of BK: sub-bucket b's rows
// b Cg .. b Cg + cnt - 1, each step rows r0 .. r0 + BK - 1 below lim
struct RowSteps {
  int b, j0, r0, lim;
  __device__ __forceinline__ bool first(const Args& p, int e) {
    b = -1, j0 = 0, lim = 0;
    return advance(p, e, true);
  }
  __device__ __forceinline__ bool advance(const Args& p, int e, bool start = false) {
    if (!start) j0 += BK;
    while (b < 0 || b * p.Cg + j0 >= lim) {
      if (++b >= p.B) return false;
      j0 = 0;
      lim = b * p.Cg + min(max(p.cnt[e * p.B + b], 0), p.Cg);
    }
    r0 = b * p.Cg + j0;
    return true;
  }
};

// ---------------------------------------------------------- (a) up -----
constexpr int AM = 128, AN = 64;

template <bool HT>
__global__ void __launch_bounds__(kThreads, 1) bwd_up(const Args p) {
  using U = Up<HT>;
  using TX = Tile<AM, BK>;   // X and DY: [rows][k]
  using TW = Tile<BK, AN>;   // Wg, Wu: [k][n]
  using TD = Tile<AN, BK>;   // Wd^T: [n][k] (Wd's rows f, contiguous d)
  __shared__ __align__(16) bf16 sX[AM * TX::kStride], sY[AM * TX::kStride];
  __shared__ __align__(16) bf16 sG[BK * TW::kStride], sU[BK * TW::kStride];
  __shared__ __align__(16) bf16 sD[AN * TD::kStride];
  const int e = blockIdx.z, m0 = blockIdx.y * AM, n0 = blockIdx.x * AN, tid = threadIdx.x;
  if (!__syncthreads_or(tid < AM && occupied(p, e, m0 + tid))) return;

  const bf16* xr[TX::kChunks];
  const typename U::T* yr[TX::kChunks];
#pragma unroll
  for (int i = 0; i < TX::kChunks; ++i) {
    const int r = m0 + TX::row(i);
    const bool occ = occupied(p, e, r);
    float s;
    xr[i] = occ ? p.x.row(e * p.C + r, s) : nullptr;
    yr[i] = occ ? U::row(p, e * p.C + r, s) : nullptr;
  }
  const bf16* wg = p.wg + (size_t)e * p.D * p.F;
  const bf16* wu = p.wu + (size_t)e * p.D * p.F;
  const bf16* wd = p.wd + (size_t)e * p.F * p.D;
  Chunk<bf16> cx[TX::kChunks], cg[1], cu[1], cd[1];
  Chunk<typename U::T> cy[TX::kChunks];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < TX::kChunks; ++i) {
      const int k = k0 + TX::col(i);
      cx[i].fetch(xr[i] && k < p.D ? xr[i] + k : nullptr, 1.f);
      cy[i].fetch(yr[i] && k < p.D ? yr[i] + k : nullptr, 1.f);
    }
    const int kw = k0 + TW::row(0), nw = n0 + TW::col(0);
    const bool lw = kw < p.D && nw < p.F;
    cg[0].fetch(lw ? wg + (size_t)kw * p.F + nw : nullptr, 1.f);
    cu[0].fetch(lw ? wu + (size_t)kw * p.F + nw : nullptr, 1.f);
    const int nd = n0 + TD::row(0), kd = k0 + TD::col(0);
    cd[0].fetch(nd < p.F && kd < p.D ? wd + (size_t)nd * p.D + kd : nullptr, 1.f);
  };

  const int warp = tid / 32, wm = 32 * (warp / 2), wn = 32 * (warp % 2);
  float aG[2][4][4] = {}, aU[2][4][4] = {}, aH[2][4][4] = {};
  const int nk = (p.D + BK - 1) / BK;
  fetch(0);
  for (int j = 0; j < nk; ++j) {
    __syncthreads();
    TX::store(sX, cx);
    TX::store(sY, cy);
    TW::store(sG, cg);
    TW::store(sU, cu);
    TD::store(sD, cd);
    __syncthreads();
    if (j + 1 < nk) fetch((j + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      warp_mma<2, 4, false, true>(aG, sX, TX::kStride, wm, sG, TW::kStride, wn, kk);
      warp_mma<2, 4, false, true>(aU, sX, TX::kStride, wm, sU, TW::kStride, wn, kk);
      warp_mma<2, 4, false, false>(aH, sY, TX::kStride, wm, sD, TD::kStride, wn, kk);
    }
  }

  // H, DG, DU to scratch; HT: the slot weight's gradient
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = m0 + wm + 16 * mi + g + 8 * hr;
      const bool occ = occupied(p, e, r);
      const size_t slot = (size_t)e * p.C + r;
      const float wv = HT && occ ? p.w[slot] : 1.f;
      float part = 0.f;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int n = n0 + wn + 8 * nj + 2 * t;
        if (!occ || n >= p.F) continue;
        float hv[2], gd[2], ud[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float gv = aG[mi][nj][2 * hr + u], uv = aU[mi][nj][2 * hr + u];
          const float dhu = aH[mi][nj][2 * hr + u];
          const float sg = 1.0f / (1.0f + expf(-gv));
          const float a = gv * sg;
          hv[u] = __bfloat162float(__float2bfloat16_rn(a * uv));
          part += dhu * hv[u];
          const float dh = wv * dhu;
          ud[u] = dh * a;
          gd[u] = dh * uv * sg * (1.0f + gv * (1.0f - sg));
        }
        *reinterpret_cast<uint32_t*>(p.h + slot * p.F + n) = pack2(hv[0], hv[1]);
        *reinterpret_cast<uint32_t*>(p.dg + slot * p.F + n) = pack2(gd[0], gd[1]);
        *reinterpret_cast<uint32_t*>(p.du + slot * p.F + n) = pack2(ud[0], ud[1]);
      }
      if (HT) {
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        if (occ && t == 0) atomicAdd(p.dw + slot, part);
      }
    }
}

// ---------------------------------------------------------- (b) dx -----
constexpr int XM = 128, XN = 128;

template <bool HT>
__global__ void __launch_bounds__(kThreads, 1) bwd_dx(const Args p) {
  using TA = Tile<XM, BK>;   // DG / DU: [rows][k]
  using TB = Tile<XN, BK>;   // Wg^T / Wu^T: [n][k] (W's rows d, contiguous f)
  __shared__ __align__(16) bf16 sA[XM * TA::kStride], sB[XN * TB::kStride];
  const int e = blockIdx.z, m0 = blockIdx.y * XM, n0 = blockIdx.x * XN, tid = threadIdx.x;
  if (!__syncthreads_or(tid < XM && occupied(p, e, m0 + tid))) {
    if (!HT)  // LL: rows past the counts are exact zeros
      for (int i = tid; i < XM * (XN / 8); i += kThreads) {
        const int r = m0 + i / (XN / 8), n = n0 + (i % (XN / 8)) * 8;
        if (r < p.C && n < p.D)
          *reinterpret_cast<uint4*>(p.dx16 + ((size_t)e * p.C + r) * p.D + n) =
              make_uint4(0, 0, 0, 0);
      }
    return;
  }
  size_t ar[TA::kChunks];
  bool al[TA::kChunks];
#pragma unroll
  for (int i = 0; i < TA::kChunks; ++i) {
    const int r = m0 + TA::row(i);
    al[i] = occupied(p, e, r);
    ar[i] = ((size_t)e * p.C + r) * p.F;
  }
  const size_t wbase = (size_t)e * p.D * p.F;
  Chunk<bf16> ca[TA::kChunks], cb[TB::kChunks];
  const int nkf = (p.F + BK - 1) / BK;
  auto fetch = [&](int j) {
    const bool up = j >= nkf;
    const int k0 = (j - (up ? nkf : 0)) * BK;
    const bf16* a = up ? p.du : p.dg;
    const bf16* w = (up ? p.wu : p.wg) + wbase;
#pragma unroll
    for (int i = 0; i < TA::kChunks; ++i) {
      const int k = k0 + TA::col(i);
      ca[i].fetch(al[i] && k < p.F ? a + ar[i] + k : nullptr, 1.f);
    }
#pragma unroll
    for (int i = 0; i < TB::kChunks; ++i) {
      const int n = n0 + TB::row(i), k = k0 + TB::col(i);
      cb[i].fetch(n < p.D && k < p.F ? w + (size_t)n * p.F + k : nullptr, 1.f);
    }
  };

  const int warp = tid / 32, wm = 32 * (warp / 2), wn = 64 * (warp % 2);
  float acc[2][8][4] = {};
  const int nk = 2 * nkf;
  fetch(0);
  for (int j = 0; j < nk; ++j) {
    __syncthreads();
    TA::store(sA, ca);
    TB::store(sB, cb);
    __syncthreads();
    if (j + 1 < nk) fetch(j + 1);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16)
      warp_mma<2, 8, false, false>(acc, sA, TA::kStride, wm, sB, TB::kStride, wn, kk);
  }

  const int lane = tid % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = m0 + wm + 16 * mi + g + 8 * hr;
      if (r >= p.C) continue;
      const bool occ = occupied(p, e, r);
      const size_t slot = (size_t)e * p.C + r;
      if (HT) {
        if (!occ) continue;
        float* dst = p.dx32 + (size_t)p.x.index(slot) * p.D;
#pragma unroll
        for (int nj = 0; nj < 8; ++nj) {
          const int n = n0 + wn + 8 * nj + 2 * t;
          if (n < p.D)
            atomicAdd(reinterpret_cast<float2*>(dst + n),
                      make_float2(acc[mi][nj][2 * hr], acc[mi][nj][2 * hr + 1]));
        }
      } else {
        bf16* dst = p.dx16 + slot * p.D;
#pragma unroll
        for (int nj = 0; nj < 8; ++nj) {
          const int n = n0 + wn + 8 * nj + 2 * t;
          if (n < p.D)
            *reinterpret_cast<uint32_t*>(dst + n) =
                occ ? pack2(acc[mi][nj][2 * hr], acc[mi][nj][2 * hr + 1]) : 0u;
        }
      }
    }
}

// store a warp's MI x NJ fp32 tile as bf16 into a row-major (M, N) matrix
template <int MI, int NJ>
__device__ __forceinline__ void store_bf16(bf16* out, int M, int N, int m0, int n0,
                                           const float (&acc)[MI][NJ][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + 16 * mi + g + 8 * hr;
      if (m >= M) continue;
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        const int n = n0 + 8 * nj + 2 * t;
        if (n < N)
          *reinterpret_cast<uint32_t*>(out + (size_t)m * N + n) =
              pack2(acc[mi][nj][2 * hr], acc[mi][nj][2 * hr + 1]);
      }
    }
}

// ------------------------------------------------------- (c) dw_up -----
constexpr int UM = 128, UN = 64;  // rows d, columns f

template <bool HT>
__global__ void __launch_bounds__(kThreads, 1) bwd_dw_up(const Args p) {
  using TA = Tile<BK, UM>;   // X^T: [k = slot rows][m = d]
  using TB = Tile<BK, UN>;   // DG, DU: [k = slot rows][n = f]
  __shared__ __align__(16) bf16 sA[BK * TA::kStride];
  __shared__ __align__(16) bf16 sG[BK * TB::kStride], sU[BK * TB::kStride];
  const int e = blockIdx.z, m0 = blockIdx.y * UM, n0 = blockIdx.x * UN, tid = threadIdx.x;
  Chunk<bf16> ca[TA::kChunks], cg[TB::kChunks], cu[TB::kChunks];
  auto fetch = [&](const RowSteps& st) {
#pragma unroll
    for (int i = 0; i < TA::kChunks; ++i) {
      const int r = st.r0 + TA::row(i), m = m0 + TA::col(i);
      float s;
      const bf16* row = r < st.lim && m < p.D ? p.x.row(e * p.C + r, s) : nullptr;
      ca[i].fetch(row ? row + m : nullptr, 1.f);
    }
#pragma unroll
    for (int i = 0; i < TB::kChunks; ++i) {
      const int r = st.r0 + TB::row(i), n = n0 + TB::col(i);
      const size_t off = ((size_t)e * p.C + r) * p.F + n;
      const bool live = r < st.lim && n < p.F;
      cg[i].fetch(live ? p.dg + off : nullptr, 1.f);
      cu[i].fetch(live ? p.du + off : nullptr, 1.f);
    }
  };

  const int warp = tid / 32, wm = 32 * (warp / 2), wn = 32 * (warp % 2);
  float aG[2][4][4] = {}, aU[2][4][4] = {};
  RowSteps cur, nxt;
  bool more = cur.first(p, e);
  if (more) fetch(cur);
  while (more) {
    __syncthreads();
    TA::store(sA, ca);
    TB::store(sG, cg);
    TB::store(sU, cu);
    __syncthreads();
    nxt = cur;
    more = nxt.advance(p, e);
    if (more) fetch(nxt);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      warp_mma<2, 4, true, true>(aG, sA, TA::kStride, wm, sG, TB::kStride, wn, kk);
      warp_mma<2, 4, true, true>(aU, sA, TA::kStride, wm, sU, TB::kStride, wn, kk);
    }
    cur = nxt;
  }
  const size_t out = (size_t)e * p.D * p.F;
  store_bf16(p.dwg + out, p.D, p.F, m0 + wm, n0 + wn, aG);
  store_bf16(p.dwu + out, p.D, p.F, m0 + wm, n0 + wn, aU);
}

// ----------------------------------------------------- (d) dw_down -----
constexpr int DM = 128, DN = 128;  // rows f, columns d

template <bool HT>
__global__ void __launch_bounds__(kThreads, 1) bwd_dw_down(const Args p) {
  using U = Up<HT>;
  using TA = Tile<BK, DM>;   // H^T: [k = slot rows][m = f]
  using TB = Tile<BK, DN>;   // w * DY: [k = slot rows][n = d]
  __shared__ __align__(16) bf16 sA[BK * TA::kStride], sB[BK * TB::kStride];
  const int e = blockIdx.z, m0 = blockIdx.y * DM, n0 = blockIdx.x * DN, tid = threadIdx.x;
  Chunk<bf16> ca[TA::kChunks];
  Chunk<typename U::T> cb[TB::kChunks];
  auto fetch = [&](const RowSteps& st) {
#pragma unroll
    for (int i = 0; i < TA::kChunks; ++i) {
      const int r = st.r0 + TA::row(i), m = m0 + TA::col(i);
      ca[i].fetch(r < st.lim && m < p.F ? p.h + ((size_t)e * p.C + r) * p.F + m : nullptr,
                  1.f);
    }
#pragma unroll
    for (int i = 0; i < TB::kChunks; ++i) {
      const int r = st.r0 + TB::row(i), n = n0 + TB::col(i);
      const int slot = e * p.C + r;
      float s = 1.f;
      const typename U::T* row = r < st.lim && n < p.D ? U::row(p, slot, s) : nullptr;
      cb[i].fetch(row ? row + n : nullptr, HT && row ? p.w[slot] : 1.f);
    }
  };

  const int warp = tid / 32, wm = 32 * (warp / 2), wn = 64 * (warp % 2);
  float acc[2][8][4] = {};
  RowSteps cur, nxt;
  bool more = cur.first(p, e);
  if (more) fetch(cur);
  while (more) {
    __syncthreads();
    TA::store(sA, ca);
    TB::store(sB, cb);
    __syncthreads();
    nxt = cur;
    more = nxt.advance(p, e);
    if (more) fetch(nxt);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16)
      warp_mma<2, 8, true, true>(acc, sA, TA::kStride, wm, sB, TB::kStride, wn, kk);
    cur = nxt;
  }
  store_bf16(p.dwd + (size_t)e * p.F * p.D, p.F, p.D, m0 + wm, n0 + wn, acc);
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <bool HT>
int launch(const Args& p, cudaStream_t st) {
  if (p.E == 0 || p.C == 0 || p.D == 0 || p.F == 0) return 0;  // the wrapper fills zeros
  bwd_up<HT><<<dim3(cdiv(p.F, AN), cdiv(p.C, AM), p.E), kThreads, 0, st>>>(p);
  bwd_dx<HT><<<dim3(cdiv(p.D, XN), cdiv(p.C, XM), p.E), kThreads, 0, st>>>(p);
  bwd_dw_up<HT><<<dim3(cdiv(p.F, UN), cdiv(p.D, UM), p.E), kThreads, 0, st>>>(p);
  bwd_dw_down<HT><<<dim3(cdiv(p.D, DN), cdiv(p.F, DM), p.E), kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// LL: x, dy, dx (E*C, D) bf16; cnt (E*B,) int32 clamped to C / B; weights
// (E, D, F) / (E, F, D) bf16 and their gradients; h, dg, du (E*C, F) bf16
// scratch.  Every pointer 16-byte aligned and D, F multiples of 8 (the
// wrapper checks)
extern "C" int grouped_swiglu_bwd_launch(const void* x, const void* cnt, const void* wg,
                                         const void* wu, const void* wd, const void* dy,
                                         void* h, void* dg, void* du, void* dx, void* dwg,
                                         void* dwu, void* dwd, int E, int C, int B, int D,
                                         int F, void* stream) {
  Args p{};
  p.cnt = static_cast<const int*>(cnt);
  p.E = E, p.C = C, p.B = B, p.Cg = B > 0 ? C / B : 0, p.D = D, p.F = F;
  p.x = Rows<bf16>{static_cast<const bf16*>(x), nullptr, nullptr, D, E * C, 0};
  p.dy16 = Rows<bf16>{static_cast<const bf16*>(dy), nullptr, nullptr, D, E * C, 0};
  p.wg = static_cast<const bf16*>(wg), p.wu = static_cast<const bf16*>(wu);
  p.wd = static_cast<const bf16*>(wd);
  p.h = static_cast<bf16*>(h), p.dg = static_cast<bf16*>(dg), p.du = static_cast<bf16*>(du);
  p.dx16 = static_cast<bf16*>(dx);
  p.dwg = static_cast<bf16*>(dwg), p.dwu = static_cast<bf16*>(dwu);
  p.dwd = static_cast<bf16*>(dwd);
  return launch<false>(p, reinterpret_cast<cudaStream_t>(stream));
}

// HT: x_ext (Tp1, D) bf16; src, w_slot, cnt as the forward takes them; dout
// (Tp1 - 1, D) fp32; dx (Tp1, D) fp32 and dw_slot (E*C,) fp32, both zeroed
// by the caller; the rest as above with B = 1
extern "C" int gather_swiglu_scatter_bwd_launch(
    const void* x_ext, const void* src, const void* w_slot, const void* cnt, const void* wg,
    const void* wu, const void* wd, const void* dout, void* h, void* dg, void* du, void* dx,
    void* dw_slot, void* dwg, void* dwu, void* dwd, int Tp1, int E, int C, int D, int F,
    void* stream) {
  Args p{};
  const int* rows = static_cast<const int*>(src);
  p.cnt = static_cast<const int*>(cnt);
  p.E = E, p.C = C, p.B = 1, p.Cg = C, p.D = D, p.F = F;
  p.x = Rows<bf16>{static_cast<const bf16*>(x_ext), rows, nullptr, D, Tp1, 1};
  p.dy32 = Rows<float>{static_cast<const float*>(dout), rows, nullptr, D, Tp1 - 1, 0};
  p.w = static_cast<const float*>(w_slot);
  p.wg = static_cast<const bf16*>(wg), p.wu = static_cast<const bf16*>(wu);
  p.wd = static_cast<const bf16*>(wd);
  p.h = static_cast<bf16*>(h), p.dg = static_cast<bf16*>(dg), p.du = static_cast<bf16*>(du);
  p.dw = static_cast<float*>(dw_slot);
  p.dx32 = static_cast<float*>(dx);
  p.dwg = static_cast<bf16*>(dwg), p.dwu = static_cast<bf16*>(dwu);
  p.dwd = static_cast<bf16*>(dwd);
  return launch<true>(p, reinterpret_cast<cudaStream_t>(stream));
}
