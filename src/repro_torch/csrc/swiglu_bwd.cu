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
// bf16 tensor cores: at qwen2-moe's HT training step (15,853 occupied rows,
// D 2048, F 1408) 0.73 TFLOP, 0.74 ms at 989 TFLOP/s, beside 2.2 GB of
// weights read and their gradients written (0.66 ms).
//
// Design: a prepass packs each expert's occupied rows together (LL) or
// gathers them (HT), then five GEMM passes, each a launch of the
// grouped-expert tile loop of the forwards (swiglu_tiles.cuh: a producer
// warpgroup keeping a 4-stage, 192 KB TMA ring full; two 64-row consumer
// warpgroups on wgmma.m64n128k16, bf16 in, fp32 accumulators, setmaxnreg),
// all through 3-D tensor maps with the 128-byte swizzle, over an expert's
// rows 0 .. n_e - 1:
//
//   (a1) dhu:     rows x F (128 x 256): DHu = bf16(DY) Wd^T over K = D into
//                 fp32 scratch (E*C, F); Wd as stored (E, F, D) is a
//                 K-major B (one 64 x 128 box a tile).
//   (a2) up:      rows x F (128 x 128): G and U over K = D (Wg, Wu as the
//                 forward's kUp reads them: MN-major); the epilogue reads
//                 DHu and writes H, DG, DU into bf16 scratch (E*C, F) and,
//                 HT, each row's part of dw (fp32 atomics over the F tiles).
//   (b)  dx:      rows x D (128 x 256): K = 2F from two sources in turn, DG
//                 with Wg, then DU with Wu (the weights as stored are
//                 K-major B); LL stores bf16 rows back where they came from
//                 (its prepass wrote the other rows' zeros), HT adds them
//                 into the token rows.
//   (c)  dw_up:   D x F (128 x 128) of one expert: dWg and dWu, A = X^T
//                 (MN-major A: wgmma's transposed A, its k-steps 16 rows of
//                 the stored X), B = DG, DU; K = the expert's occupied rows.
//   (d)  dw_down: F x D (128 x 256): dWd, A = H^T, B = bf16(w DY); K as (c).
//
// What each point of the design does:
// 1. Pass (a) as one loop would hold three 64 x 128 fp32 accumulators (192
//    registers a consumer thread) and 80 KB stages (two in 227 KB);
//    64-column F tiles would re-read the X and DY rows 22 times from L2.
//    DHu in a pass of its own (a1) keeps both halves on the forwards' two
//    accumulators, 128-column tiles and 4-stage ring, for one fp32 round
//    trip of DHu (E*C x F: 185 MB at HT's 32,768 slots, 369 MB at LL's
//    65,536 rows; the bytes of the occupied rows move, ~0.05 ms).
// 2. Rows past the count inside a reduction over rows ((c), (d)): a box of
//    64 rows reaches past an expert's n_e rows, into scratch that holds
//    whatever it held (NaN included).  The consumers write zeros over those
//    rows of both operands in shared memory in the step where the count
//    ends (swiglu_tiles.cuh clear_rows; then fence.proxy.async and a named
//    barrier of the two consumers), so NaN x 0 never arises and no pass
//    has to leave zeros in device memory for the next.  Passes (a1), (a2),
//    (b) need nothing: a product row depends on its own A row only, and
//    rows past the count are not written.
// 3. The prepasses (a warp a row).  LL's (E, B) sub-buckets hold ~68 rows
//    each at the training shape, so 64-row halves and steps over them would
//    run half empty; compact_rows packs an expert's prefixes in order into
//    xs, dys (2 x 268 MB of scratch at 65,536 rows; the occupied rows move,
//    ~0.13 GB) and zeroes the other rows of dx.  HT's rows come through src
//    from fp32 upstream (Hopper has no TMA gather): gather_rows writes, for
//    the occupied slots only, x_ext[src] and bf16(DY), bf16(w DY) of
//    dout[src] into (E*C, D) bf16 scratch (3 x 134 MB at 32,768 slots;
//    15,853 occupied rows: ~0.2 GB moved).  Every pass is then a plain
//    TMA-fed GEMM on contiguous rows, the same code for LL (w = 1) and HT,
//    where the forward's cp.async gathering producer would hold fp32 rows
//    and a conversion in the ring.
// 4. Short reductions in (c), (d): ~250 rows an expert, 4 steps of 64, and
//    1.1 GB of bf16 weight gradients stored (>= 0.33 ms alone).  With one
//    tile a block, the ring's fill and a 64 KB epilogue of 4-byte stores
//    took over half of each tile.  So their blocks are persistent, one an
//    SM, each walking tiles (expert outermost, so the blocks in flight
//    share an expert's rows in L2): the producer fills the next tile's
//    stages while the consumers store this one.  And the stores do not
//    hold the consumers: each stages its 64 x 128 outputs in 16 KB of
//    shared memory past the ring and hands them to TMA stores, which run
//    on under the next tile's products (with the stores left out, these
//    passes took half their time).
// 5. Row tiles with no occupied row load nothing and issue no wgmma (their
//    consumers are inactive, as in the forwards); an expert without rows
//    reduces over no step and stores zero weight gradients.
// 6. dX (HT) and dw add with fp32 atomics in run-to-run order, as before.
//
// Nothing saved from the forward is read: the backward recomputes G and U,
// so a layer recomputed under checkpoint costs its forward launch again and
// no memory between the passes.
#include "swiglu_tiles.cuh"

namespace swiglu_bwd {

using namespace swiglu_tiles;

// the passes, one kernel name each (profiles read the passes by name)
struct dhu { static constexpr int kEpi = kDHu; };
struct up { static constexpr int kEpi = kBwdUp; };
struct dx { static constexpr int kEpi = kDxStore; };
struct dx_add { static constexpr int kEpi = kDxScatter; };
struct dw_up { static constexpr int kEpi = kDWUp; };
struct dw_down { static constexpr int kEpi = kDWDown; };

// a0 / a1: A (a1 the second source of dx); b0 / b1: B; o0 / o1: the weight
// gradients' passes' outputs (their TMA stores)
template <class P>
__global__ void __launch_bounds__(kThreads, 1)
    pass(const __grid_constant__ CUtensorMap a0, const __grid_constant__ CUtensorMap a1,
         const __grid_constant__ CUtensorMap b0, const __grid_constant__ CUtensorMap b1,
         const __grid_constant__ CUtensorMap o0, const __grid_constant__ CUtensorMap o1,
         const Args p) {
  tile_body<P::kEpi, false>(&a0, &a1, &b0, &b1, &o0, &o1, p);
}

// one launch of pass P (o0 / o1 unread but by the weight gradients' passes)
template <class P>
static int start(dim3 grid, const CUtensorMap& a0, const CUtensorMap& a1,
                 const CUtensorMap& b0, const CUtensorMap& b1, const CUtensorMap& o0,
                 const CUtensorMap& o1, const Args& p, cudaStream_t st) {
  constexpr int smem = rows_k<P::kEpi>() ? kSmemRK : kSmem;
  // above 48 KB of dynamic shared memory: once a device
  static unsigned long long raised = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(raised & bit)) {
    cudaFuncSetAttribute(pass<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    raised |= bit;
  }
  pass<P><<<grid, kThreads, smem, st>>>(a0, a1, b0, b1, o0, o1, p);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kGatherWarps = 8;  // the prepasses: a warp a row

// LL's prepass: each expert's occupied rows (sub-bucket b's prefix of
// cnt[e, b] rows from row b Cg) packed in order into rows 0 .. n_e - 1 of
// its C rows of xs and dys, the row each came from in rows[], n_e in
// cnt_e[e]; every other row of dx written as zeros (the dx pass writes
// the occupied ones)
__global__ void __launch_bounds__(32 * kGatherWarps)
    compact_rows(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                 const int* __restrict__ cnt, bf16* __restrict__ xs, bf16* __restrict__ dys,
                 int* __restrict__ rows, int* __restrict__ cnt_e, bf16* __restrict__ dx, int C,
                 int B, int Cg, int D, int n_rows) {
  const int row = blockIdx.x * kGatherWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const int e = row / C, r = row - e * C, b = r / Cg;
  int off = 0, n_b = 0, n_e = 0;
  for (int k = 0; k < B; ++k) {
    const int n = min(max(cnt[e * B + k], 0), Cg);
    off += k < b ? n : 0;
    n_b = k == b ? n : n_b;
    n_e += n;
  }
  if (r == 0 && lane == 0) cnt_e[e] = n_e;
  const size_t src = (size_t)row * D;
  if (r - b * Cg >= n_b) {
    for (int k = 8 * lane; k < D; k += 8 * 32)
      *reinterpret_cast<uint4*>(dx + src + k) = make_uint4(0, 0, 0, 0);
    return;
  }
  const int to = e * C + off + r - b * Cg;
  if (lane == 0) rows[to] = row;
  const size_t dst = (size_t)to * D;
  for (int k = 8 * lane; k < D; k += 8 * 32) {
    *reinterpret_cast<uint4*>(xs + dst + k) = __ldg(reinterpret_cast<const uint4*>(x + src + k));
    *reinterpret_cast<uint4*>(dys + dst + k) =
        __ldg(reinterpret_cast<const uint4*>(dy + src + k));
  }
}

// HT's prepass: for each occupied slot s, x_ext[src[s]] (clamped into the
// table, as the forward gathers), bf16(dout[src[s]]) and bf16(w[s] *
// dout[src[s]]) (zeros for a row at or past T, the scratch row) into rows s
// of xs, dys, dyws; 8 elements a lane a step

__global__ void __launch_bounds__(32 * kGatherWarps)
    gather_rows(const bf16* __restrict__ x_ext, const int* __restrict__ src,
                const float* __restrict__ w, const int* __restrict__ cnt,
                const float* __restrict__ dout, bf16* __restrict__ xs, bf16* __restrict__ dys,
                bf16* __restrict__ dyws, int Tp1, int C, int D, int n_slots) {
  const int slot = blockIdx.x * kGatherWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (slot >= n_slots) return;
  const int e = slot / C;
  if (slot - e * C >= cnt[e]) return;
  const int tok = src[slot];
  const bf16* xr = x_ext + (size_t)min(max(tok, 0), Tp1 - 1) * D;
  const float* yr = tok >= 0 && tok < Tp1 - 1 ? dout + (size_t)tok * D : nullptr;
  const float ws = w[slot];
  const size_t out = (size_t)slot * D;
  for (int k = 8 * lane; k < D; k += 8 * 32) {
    *reinterpret_cast<uint4*>(xs + out + k) = __ldg(reinterpret_cast<const uint4*>(xr + k));
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (yr != nullptr) {
      a = __ldg(reinterpret_cast<const float4*>(yr + k));
      b = __ldg(reinterpret_cast<const float4*>(yr + k) + 1);
    }
    *reinterpret_cast<uint4*>(dys + out + k) = make_uint4(
        pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
    *reinterpret_cast<uint4*>(dyws + out + k) =
        make_uint4(pack_bf16(ws * a.x, ws * a.y), pack_bf16(ws * a.z, ws * a.w),
                   pack_bf16(ws * b.x, ws * b.y), pack_bf16(ws * b.z, ws * b.w));
  }
}

// the operands of the five passes: contiguous (E, C, D) rows x, bf16(DY),
// bf16(w DY); the weights; the (E*C, F) scratch; the outputs
struct Bufs {
  const bf16 *x, *dy, *dyw, *wg, *wu, *wd;
  bf16 *h, *dg, *du;
  float* dhu;
  bf16* dx16;   // LL
  float* dx32;  // HT: (s_nrows, D), atomically added
  bf16 *dwg, *dwu, *dwd;
};

// the five passes of one call; ``p`` carries the counts and, HT, the
// slots' token rows, weights and dw (``ht``)
int passes(Args p, int E, int D, int F, const Bufs& q, bool ht, cudaStream_t st) {
  const int C = p.C;
  p.a_box = act_box(C);
  CUtensorMap mx, mdy, mdyw, mh, mdg, mdu, wg_n, wu_n, wd_k, wg_k, wu_k;
  // activations (E, C, K): boxes of 64 K x a_box rows (or 64 columns x
  // a_box rows of K where the rows are the reduction)
  int r = map_3d(&mx, q.x, D, C, E, p.a_box);
  if (r == 0) r = map_3d(&mdy, q.dy, D, C, E, p.a_box);
  if (r == 0) r = map_3d(&mdyw, q.dyw, D, C, E, p.a_box);
  if (r == 0) r = map_3d(&mh, q.h, F, C, E, p.a_box);
  if (r == 0) r = map_3d(&mdg, q.dg, F, C, E, p.a_box);
  if (r == 0) r = map_3d(&mdu, q.du, F, C, E, p.a_box);
  // Wg, Wu (E, D, F) as (a2) reads them: B[k = d][n = f], MN-major
  if (r == 0) r = map_3d(&wg_n, q.wg, F, D, E, BK);
  if (r == 0) r = map_3d(&wu_n, q.wu, F, D, E, BK);
  // K-major B, 64 K x 128 N: Wd (E, F, D) for (a1), B[k = d][n = f]; Wg,
  // Wu (E, D, F) for (b), B[k = f][n = d]
  if (r == 0) r = map_3d(&wd_k, q.wd, D, F, E, BT);
  if (r == 0) r = map_3d(&wg_k, q.wg, F, D, E, BT);
  if (r == 0) r = map_3d(&wu_k, q.wu, F, D, E, BT);
  // the weight gradients, stored by TMA from 64 x 64 boxes
  CUtensorMap o_wg, o_wu, o_wd;
  if (r == 0) r = map_3d(&o_wg, q.dwg, F, D, E, BK);
  if (r == 0) r = map_3d(&o_wu, q.dwu, F, D, E, BK);
  if (r == 0) r = map_3d(&o_wd, q.dwd, D, F, E, BK);
  if (r != 0) return -r;
  const auto grid = [E](int N, int M, int cols) {
    return dim3((N + cols - 1) / cols, (M + BM - 1) / BM, E);
  };

  Args a1 = p;  // (a1) DHu
  a1.K = D, a1.N = F, a1.out_f32 = q.dhu;
  int err = start<dhu>(grid(F, C, 2 * BT), mdy, mdy, wd_k, wd_k, mdy, mdy, a1, st);
  if (err != 0) return err;

  Args a2 = p;  // (a2) H, DG, DU (HT: dw)
  a2.K = D, a2.N = F, a2.in_f32 = q.dhu;
  a2.out_bf16 = q.h, a2.out2_bf16 = q.dg, a2.out3_bf16 = q.du;
  err = start<up>(grid(F, C, BT), mx, mx, wg_n, wu_n, mx, mx, a2, st);
  if (err != 0) return err;

  Args b = p;  // (b) dX
  b.K = F, b.N = D, b.out_bf16 = q.dx16, b.out_f32 = q.dx32;
  err = ht ? start<dx_add>(grid(D, C, 2 * BT), mdg, mdu, wg_k, wu_k, mdg, mdg, b, st)
           : start<dx>(grid(D, C, 2 * BT), mdg, mdu, wg_k, wu_k, mdg, mdg, b, st);
  if (err != 0) return err;

  // (c), (d): persistent blocks, one an SM, walking the (expert, M tile,
  // N tile) tiles
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const auto walk = [E, sms](Args& a, int M, int N, int cols) {
    a.M = M, a.N = N, a.E = E;
    a.tm = (M + BM - 1) / BM, a.tn = (N + cols - 1) / cols;
    return dim3(min(E * a.tm * a.tn, max(sms, 1)));
  };
  Args c = p;  // (c) dWg, dWu
  c.out_bf16 = q.dwg, c.out2_bf16 = q.dwu;
  const dim3 gc = walk(c, D, F, BT);
  err = start<dw_up>(gc, mx, mx, mdg, mdu, o_wg, o_wu, c, st);
  if (err != 0) return err;

  Args d = p;  // (d) dWd
  d.out_bf16 = q.dwd;
  const dim3 gd = walk(d, F, D, 2 * BT);
  return start<dw_down>(gd, mh, mh, mdyw, mdyw, o_wd, o_wd, d, st);
}

}  // namespace swiglu_bwd

using swiglu_bwd::Bufs;
using swiglu_tiles::Args;
using swiglu_tiles::bf16;

// LL: x, dy, dx (E*C, D) bf16; cnt (E*B,) int32 clamped to C / B; weights
// (E, D, F) / (E, F, D) bf16 and their gradients; xs, dys (E*C, D) bf16,
// rows (E*C,) int32 and cnt_e (E,) int32 the prepass's scratch;
// h, dg, du (E*C, F) bf16 and dhu (E*C, F) fp32 scratch.  Every pointer
// 16-byte aligned and D, F multiples of 8 (the wrapper checks)
extern "C" int grouped_swiglu_bwd_launch(const void* x, const void* cnt, const void* wg,
                                         const void* wu, const void* wd, const void* dy,
                                         void* xs, void* dys, void* rows, void* cnt_e, void* h,
                                         void* dg, void* du, void* dhu, void* dx, void* dwg,
                                         void* dwu, void* dwd, int E, int C, int B, int D,
                                         int F, void* stream) {
  if (E == 0 || C == 0 || D == 0 || F == 0 || B == 0) return 0;  // the wrapper fills zeros
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int n_rows = E * C;
  swiglu_bwd::compact_rows<<<(n_rows + swiglu_bwd::kGatherWarps - 1) / swiglu_bwd::kGatherWarps,
                             32 * swiglu_bwd::kGatherWarps, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), static_cast<const int*>(cnt),
      static_cast<bf16*>(xs), static_cast<bf16*>(dys), static_cast<int*>(rows),
      static_cast<int*>(cnt_e), static_cast<bf16*>(dx), C, B, C / B, D, n_rows);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  Args p{};
  p.cnt = static_cast<const int*>(cnt_e);
  p.C = C, p.B = 1, p.Cg = C;
  p.s_rows = static_cast<const int*>(rows);
  Bufs q{};
  q.x = static_cast<const bf16*>(xs);
  q.dy = q.dyw = static_cast<const bf16*>(dys);  // w = 1
  q.wg = static_cast<const bf16*>(wg), q.wu = static_cast<const bf16*>(wu);
  q.wd = static_cast<const bf16*>(wd);
  q.h = static_cast<bf16*>(h), q.dg = static_cast<bf16*>(dg), q.du = static_cast<bf16*>(du);
  q.dhu = static_cast<float*>(dhu);
  q.dx16 = static_cast<bf16*>(dx);
  q.dwg = static_cast<bf16*>(dwg), q.dwu = static_cast<bf16*>(dwu);
  q.dwd = static_cast<bf16*>(dwd);
  return swiglu_bwd::passes(p, E, D, F, q, false, st);
}

// HT: x_ext (Tp1, D) bf16; src, w_slot, cnt as the forward takes them; dout
// (Tp1 - 1, D) fp32; xs, dys, dyws (E*C, D) bf16 scratch (the prepass's);
// dx (Tp1, D) fp32 and dw_slot (E*C,) fp32, both zeroed by the caller; the
// rest as above with B = 1
extern "C" int gather_swiglu_scatter_bwd_launch(
    const void* x_ext, const void* src, const void* w_slot, const void* cnt, const void* wg,
    const void* wu, const void* wd, const void* dout, void* xs, void* dys, void* dyws, void* h,
    void* dg, void* du, void* dhu, void* dx, void* dw_slot, void* dwg, void* dwu, void* dwd,
    int Tp1, int E, int C, int D, int F, void* stream) {
  if (E == 0 || C == 0 || D == 0 || F == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int n_slots = E * C;
  swiglu_bwd::gather_rows<<<(n_slots + swiglu_bwd::kGatherWarps - 1) / swiglu_bwd::kGatherWarps,
                            32 * swiglu_bwd::kGatherWarps, 0, st>>>(
      static_cast<const bf16*>(x_ext), static_cast<const int*>(src),
      static_cast<const float*>(w_slot), static_cast<const int*>(cnt),
      static_cast<const float*>(dout), static_cast<bf16*>(xs), static_cast<bf16*>(dys),
      static_cast<bf16*>(dyws), Tp1, C, D, n_slots);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  Args p{};
  p.cnt = static_cast<const int*>(cnt);
  p.C = C, p.B = 1, p.Cg = C;
  p.s_rows = static_cast<const int*>(src);
  p.s_w = static_cast<const float*>(w_slot);
  p.s_nrows = Tp1;
  p.dw = static_cast<float*>(dw_slot);
  Bufs q{};
  q.x = static_cast<const bf16*>(xs);
  q.dy = static_cast<const bf16*>(dys), q.dyw = static_cast<const bf16*>(dyws);
  q.wg = static_cast<const bf16*>(wg), q.wu = static_cast<const bf16*>(wu);
  q.wd = static_cast<const bf16*>(wd);
  q.h = static_cast<bf16*>(h), q.dg = static_cast<bf16*>(dg), q.du = static_cast<bf16*>(du);
  q.dhu = static_cast<float*>(dhu);
  q.dx32 = static_cast<float*>(dx);
  q.dwg = static_cast<bf16*>(dwg), q.dwu = static_cast<bf16*>(dwu);
  q.dwd = static_cast<bf16*>(dwd);
  return swiglu_bwd::passes(p, E, D, F, q, true, st);
}
