// Shared tile loop of the grouped expert kernels (grouped_matmul.cu,
// grouped_swiglu.cu, grouped_swiglu_db.cu, gather_swiglu_scatter.cu) and of
// their backward (swiglu_bwd.cu, whose header describes its six passes).
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
// to x.dtype (grouped_matmul.py:144).  grouped_matmul is pass (b) alone.
//
// What bounds it on an H100: at every shape these kernels are served at,
// reading the weights.  LL decode holds a few rows an expert (64 rows over
// 15 experts at qwen2-moe's batch 4): about 4 flops per weight byte read,
// far under the ~295 at which the tensor cores would bound it.  The HT prefill
// and the grouped matmul hold up to 128 rows an expert: 128 flops a byte,
// still under.  So the loop is built to keep HBM busy: every weight tile is
// read once per expert and row tile, with enough bytes in flight that the
// reads never wait on latency, and the products hide under the loads.
//
// A block owns one 128-row output tile of one expert (128 columns for kUp,
// 256 for kDown) and walks the reduction dim K in steps of 64 (one
// 128-byte swizzle row of bf16):
//
// - The ring.  Warpgroup 0 is the producer: one thread (one warp when rows
//   are gathered) fills a ring of 4 shared-memory stages of 48 KB (192 KB),
//   waiting on each stage's "empty" mbarrier before it refills it.  A stage
//   holds the A tile and two 128-column weight tiles: gate and up of the
//   same columns in kUp, two neighbouring column tiles in kDown.  Weight
//   tiles come by TMA through a 3-D tensor map over (E, K, N) with the
//   128-byte swizzle, as two 64-column boxes a tile; completion is counted
//   on the stage's "full" mbarrier.  TMA's zero fill past an edge masks the
//   ragged K and N tiles (the wrapper requires K and N to be multiples of
//   8, which keeps the global strides 16-byte aligned).
// - The token rows.  Contiguous rows (the grouped matmul's and the grouped
//   SwiGLU's x, and h in every kDown pass) come by TMA through a 3-D map
//   over (E, C, K): a box of up to 64 rows for each consumer whose rows hold
//   an occupied one, rows past C zero-filled, so a tile never reads the
//   next expert's rows.  Gathered rows (gather_swiglu_scatter's kUp; Hopper
//   has no TMA gather) come by cp.async from the producer warp, which writes
//   the same 128-byte swizzle the descriptors read (16-byte chunk index XOR
//   row % 8), zero-fills rows at or past the count, and marks a stage full
//   once it has landed (cp.async.wait_group, with three stages left in
//   flight) and after a proxy fence (cp.async writes through the generic
//   proxy; wgmma reads through the async one).  It does so before it waits
//   to refill the next stage, so the consumers never wait on its refills.
//   The gathering producer is its own instance of the kernel (GATHER), so
//   the others carry none of its registers.
// - The products.  Warpgroups 1 and 2 are consumers of 64 rows each:
//   wgmma.m64n128k16, bf16 in, fp32 accumulators in registers (two of 64
//   a thread), A (rows, K-major) and B (the weights, N contiguous:
//   MN-major, as V is in flash_attention.cu) both read from shared memory
//   by descriptor.  kUp applies silu(g) * u to its two accumulators in
//   registers.  Each consumer keeps one step's products in flight and
//   releases the stage before it.  A consumer whose 64 rows are all
//   unoccupied issues no wgmma and takes no part in the ring (the empty
//   barriers count only the active consumers' warps).  setmaxnreg moves
//   registers from the producer (56) to the consumers (224).
// - 128-row tiles.  A 128-row HT expert (the served C) streams each weight
//   tile once, where 64-row tiles read it twice.  kDown's 256 columns halve
//   how often its A tile (h) is read again from L2 (once a column block),
//   which at C 128 is as many bytes as the weights; kUp already holds two
//   weight tiles a stage, gate and up.
// - Sub-buckets.  LL decode's counts come bucketed (E, B) by source rank,
//   each sub-bucket Cg = C / B rows with an occupied prefix.  A block tiles
//   an expert's whole C rows, so its weights stream once for all B sources
//   (the loop before this one streamed them once per occupied sub-bucket);
//   row r is occupied when r % Cg < cnt[e * B + r / Cg].  Unoccupied rows
//   inside a loaded box multiply as whatever they hold and are never
//   written: a product row depends on its own A row only.
// - Bytes in flight at decode.  About 15 occupied experts make 165 kUp
//   blocks (11 column tiles at F = 1408) and 120 kDown blocks (8 at D =
//   2048), one a SM (the ring takes 192 KB): each keeps up to 128 KB of
//   weights in flight, ~15 MB across the card, where HBM's latency needs a
//   few MB.  Narrower tiles would spread kUp's second, partial wave over
//   more SMs, but halve each TMA box and double the A reads at the HT
//   shapes; the measured decode time is in PERF.md.
//
// The backward's passes (swiglu_bwd.cu) run this loop with two more operand
// forms: a K-major weight tile (the weight's transpose, stored K
// contiguous: box 64 K x 128 N), and an MN-major A for the weight
// gradients, whose reduction runs over an expert's occupied rows (box 64 M x
// 64 rows).  Those passes walk an expert's rows (compacted by the
// backward: one count an expert) in steps of 64; in the last, partial step
// the consumers write zeros over the rows past the count in the stage's A
// and B boxes (then fence the async proxy and meet on a named barrier),
// since there every row enters the sum.  Their blocks are persistent, each
// walking tiles, and store their outputs by TMA from shared memory past
// the ring (store_tile), so that the stores run under the next tile's
// products.  Pass (b) takes its K from two sources in turn (DG with Wg,
// then DU with Wu).
//
// Unchanged from the loop before it: tiles wholly past the count load
// nothing (kDownStore still writes their zeros); rows past the count are
// written as exact zeros (kDownStore), left unwritten in h (kUp: pass (b)
// never reads them into a written row), or add nothing (kDownScatter, whose
// fp32 atomics add w_slot * y into the token row, skipping rows whose token
// index lies outside the output); gathered row indices are clamped into the
// table.
#pragma once

#include "hopper_common.cuh"

namespace swiglu_tiles {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int BM = 128;             // rows a block: two consumers of 64
constexpr int BT = 128;             // columns of one weight tile (one wgmma)
constexpr int BK = 64;              // reduction step: one swizzle row
constexpr int kThreads = 384;       // producer + two consumer warpgroups
constexpr int kRowBytes = 128;      // BK bf16
constexpr int kAHalf = 64 * kRowBytes;  // 8 KB: one consumer's rows
constexpr int kABytes = 2 * kAHalf;     // 16 KB: the A tile
constexpr int kBHalf = BK * kRowBytes;  // 8 KB: 64 columns of a weight tile
constexpr int kBBytes = 2 * kBHalf;     // 16 KB: one weight tile
constexpr int kStageBytes = kABytes + 2 * kBBytes;  // A and two weight tiles
constexpr int kStages = 4;
constexpr int kOffBar = kStages * kStageBytes;
constexpr int kSmem = kOffBar + 16 * kStages + 1024;  // + alignment
// the weight gradients' passes: each consumer's 64 x 128 bf16 output
// staged for TMA stores, after the barriers
constexpr int kOutBytes = 64 * BT * 2;
constexpr int kOffOut = kOffBar + 1024;
constexpr int kSmemRK = kOffOut + 2 * kOutBytes + 1024;
static_assert(kSmemRK <= 232448, "a block's shared memory");
constexpr int kGatherLag = 3;       // stages a gathering producer keeps open
static_assert(kStages > kGatherLag, "the gathering producer needs the lag");

// the passes: the forwards' three, then the backward's (swiglu_bwd.cu)
enum Epilogue {
  kUp = 0,         // h = bf16(silu(x Wg) * (x Wu))
  kDownStore = 1,  // y = h Wd, bf16, exact zeros past the counts
  kDownScatter = 2,  // w_slot * (h Wd) added into the token rows
  kDHu = 3,        // (a1) DHu = bf16(DY) Wd^T, fp32 out
  kBwdUp = 4,      // (a2) G, U recomputed; H, DG, DU out (HT: dw_slot)
  kDxStore = 5,    // (b) dX = DG Wg^T + DU Wu^T, bf16 into rows s_rows (LL)
  kDxScatter = 6,  // (b) the same added into the token rows (HT)
  kDWUp = 7,       // (c) dWg = X^T DG, dWu = X^T DU
  kDWDown = 8,     // (d) dWd = H^T bf16(w DY)
};

// the weight gradients' passes: A MN-major, K over an expert's occupied rows
template <int EPI>
__host__ __device__ constexpr bool rows_k() {
  return EPI == kDWUp || EPI == kDWDown;
}
// B stored K contiguous (a weight's transpose): one 64 x 128 box a tile
template <int EPI>
__host__ __device__ constexpr bool b_kmajor() {
  return EPI == kDHu || EPI == kDxStore || EPI == kDxScatter;
}
// K from two (A, B) sources in turn
template <int EPI>
__host__ __device__ constexpr bool split_k() {
  return EPI == kDxStore || EPI == kDxScatter;
}
// the two weight tiles are two matrices' same columns (kUp: gate and up),
// else two neighbouring column tiles of one
template <int EPI>
__host__ __device__ constexpr bool same_cols() {
  return EPI == kUp || EPI == kBwdUp || EPI == kDWUp;
}

// output columns a block
template <int EPI>
__host__ __device__ constexpr int block_cols() {
  return same_cols<EPI>() ? BT : 2 * BT;
}

struct Args {
  const bf16* a;       // A rows: x / x_ext (kUp) or h (kDown*)
  const int* a_rows;   // gather table, indexed e * C + r (gathering kUp)
  int a_nrows;         // rows in A's table (gathered indices are clamped)
  const int* cnt;      // (E * B,) occupied prefix of each sub-bucket
  int C, B, Cg;        // rows an expert = B sub-buckets of Cg
  int K, N;            // reduce (a split pass: each source's), output columns
  int M;               // kDW*: output rows (D or F) of an expert's gradient
  int E, tm, tn;       // kDW*: experts, and tiles of an expert's gradient
  int a_box;           // rows of a TMA activation box: min(64, C rounded up to 8)
  bf16* out_bf16;      // kUp: h;  kDownStore: y;  kDxStore: dx (rows s_rows);
                       // kBwdUp: H;
                       // kDW*: the (E, M, N) weight gradient (kDWUp: dWg)
  bf16* out2_bf16;     // kBwdUp: DG;  kDWUp: dWu
  bf16* out3_bf16;     // kBwdUp: DU
  float* out_f32;      // kDownScatter, kDxScatter: (s_nrows, N), atomically
                       // added;  kDHu: DHu (E*C, N)
  const float* in_f32; // kBwdUp: DHu
  float* dw;           // kBwdUp, HT: (E*C,) slot weights' gradient, added
  const int* s_rows;   // kDownScatter, kDxScatter: token row per slot;
                       // kDxStore: dx row per (compacted) slot
  const float* s_w;    // kDownScatter, kBwdUp (HT): combine weight per slot
  int s_nrows;
};

__device__ __forceinline__ bool occupied(const Args& p, int e, int r) {
  if (r >= p.C) return false;
  const int b = r / p.Cg;
  return r - b * p.Cg < p.cnt[e * p.B + b];
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the K steps of a pass over expert e's occupied rows 0 .. cnt[e] - 1 (the
// backward's rows are compacted: one count an expert) in steps of BK,
// ``live`` of a step's rows below the count
struct RowSteps {
  int j0 = 0;
  __device__ __forceinline__ bool next(const Args& p, int e, int& r0, int& live) {
    const int n = min(max(p.cnt[e], 0), p.C);
    if (j0 >= n) return false;
    r0 = j0;
    live = min(BK, n - j0);
    j0 += BK;
    return true;
  }
};

// Rows [live, BK) of consumer w's A box and of weight tile w's two boxes
// in stage ``st`` to zeros: rows past the count (whatever the buffer holds
// there, NaN included) must add nothing to a sum over rows.  Whole
// 128-byte rows, so the swizzle inside a row does not matter
__device__ __forceinline__ void clear_rows(uint32_t st, int w, int live, int t128) {
  const int per = (BK - live) * (kRowBytes / 16);  // 16-byte chunks a box
  for (int i = t128; i < 3 * per; i += 128) {
    const int box = i / per, c = i - box * per;
    const uint32_t at = (box == 0 ? st + w * kAHalf
                                  : st + kABytes + w * kBBytes + (box - 1) * kBHalf) +
                        (live + c / 8) * kRowBytes + (c % 8) * 16;
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(at), "r"(0) : "memory");
  }
}

// the producer: one thread (TMA rows) or one warp (gathered rows) filling
// the ring for the consumers marked in act0 / act1 with one tile's steps,
// the first of them the ring's step j0; returns the ring's next step
template <int EPI, bool GATHER>
__device__ __forceinline__ int produce(const CUtensorMap* ta0, const CUtensorMap* ta1,
                                       const CUtensorMap* tb0, const CUtensorMap* tb1,
                                       const Args& p, uint32_t base, uint32_t full,
                                       uint32_t empty, int e, int m0, int n0, bool act0,
                                       bool act1, int nkh, int nk, int j0, int lane) {
  constexpr bool RK = rows_k<EPI>(), SPLIT = split_k<EPI>(), SAME = same_cols<EPI>();
  const uint32_t a_bytes = GATHER ? 0u : (int(act0) + int(act1)) * p.a_box * kRowBytes;
  // weight tiles, or (RK) four activation boxes of a_box rows
  const uint32_t b_bytes = RK ? 4u * p.a_box * kRowBytes : 2u * kBBytes;
  // gathered: this lane's rows lane + 32 q (q 0, 1: consumer 0; 2, 3: 1)
  const bf16* rowp[4] = {nullptr, nullptr, nullptr, nullptr};
  if (GATHER) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = m0 + lane + 32 * q;
      if ((q < 2 ? act0 : act1) && occupied(p, e, r)) {
        const int row = min(max(p.a_rows[(size_t)e * p.C + r], 0), p.a_nrows - 1);
        rowp[q] = p.a + (size_t)row * p.K;
      }
    }
  }
  RowSteps rs;
  int i = 0;  // this tile's step; the ring's is j0 + i
  for (;; ++i) {
    int r0 = 0, live = BK;
    if (RK) {
      if (!rs.next(p, e, r0, live)) break;
    } else if (i >= nk) {
      break;
    }
    const int j = j0 + i;
    if (GATHER && j >= kGatherLag) {  // stage j - lag has landed: mark it full
      cp_async_wait<kGatherLag - 1>();
      fence_proxy_async();
      mbar_arrive(full + 8 * ((j - kGatherLag) % kStages));
    }
    const int s = j % kStages;
    if (j >= kStages) mbar_wait(empty + 8 * s, ((j / kStages) - 1) & 1);
    const uint32_t st = base + s * kStageBytes;
    const bool second = SPLIT && i >= nkh;
    const int k0 = RK ? r0 : (i - (second ? nkh : 0)) * BK;
    if (lane == 0) {
      mbar_expect_tx(full + 8 * s, a_bytes + b_bytes);
      if (!GATHER) {
        const CUtensorMap* ta = second ? ta1 : ta0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!(h ? act1 : act0)) continue;
          if (RK)  // (M, rows) box: the rows are K
            tma_load_3d(st + h * kAHalf, ta, full + 8 * s, m0 + 64 * h, k0, e);
          else
            tma_load_3d(st + h * kAHalf, ta, full + 8 * s, k0, m0 + 64 * h, e);
        }
      }
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const CUtensorMap* tb = SAME ? (w ? tb1 : tb0) : (second ? tb1 : tb0);
        const int col = n0 + (SAME ? 0 : BT * w);
        const uint32_t dst = st + kABytes + w * kBBytes;
        if (b_kmajor<EPI>()) {
          tma_load_3d(dst, tb, full + 8 * s, k0, col, e);
        } else {
#pragma unroll
          for (int half = 0; half < 2; ++half)
            tma_load_3d(dst + half * kBHalf, tb, full + 8 * s, col + 64 * half, k0, e);
        }
      }
    }
    if (GATHER) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!(q < 2 ? act0 : act1)) continue;
        const int lr = lane + 32 * q;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int k = k0 + 8 * c;
          const bool live_k = rowp[q] != nullptr && k < p.K;
          cp_async_16(st + lr * kRowBytes + ((c ^ (lr & 7)) << 4),
                      live_k ? static_cast<const void*>(rowp[q] + k) : p.a, live_k ? 16 : 0);
        }
      }
      cp_async_commit();
    }
  }
  if (GATHER) {  // one tile a block: j0 is 0
    cp_async_wait<0>();
    fence_proxy_async();
    for (int j = max(nk - kGatherLag, 0); j < nk; ++j) mbar_arrive(full + 8 * (j % kStages));
  }
  return j0 + i;
}

// a consumer's products of one tile, the first of its steps the ring's
// step j0: every step's stage released once its products are done;
// returns the ring's next step
template <int EPI>
__device__ __forceinline__ int consume(float (&acc)[2][64], const Args& p, uint32_t base,
                                       uint32_t full, uint32_t empty, int e, int w, int nk,
                                       int j0, int t128) {
  constexpr bool RK = rows_k<EPI>(), BKM = b_kmajor<EPI>();
  const int lane = t128 % 32;
  RowSteps rs;
  int i = 0;
  for (;; ++i) {
    int k_row = 0, live = BK;
    if (RK) {
      if (!rs.next(p, e, k_row, live)) break;
    } else if (i >= nk) {
      break;
    }
    const int j = j0 + i;
    const int s = j % kStages;
    mbar_wait(full + 8 * s, (j / kStages) & 1);
    const uint32_t st = base + s * kStageBytes;
    if (RK && live < BK) {  // the prefix ends inside this step
      clear_rows(st, w, live, t128);
      fence_proxy_async();
      asm volatile("bar.sync 1, 256;\n" ::: "memory");  // both consumers' rows
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t at = st + w * kAHalf;
      const uint64_t da = RK ? desc_sw128(at + kk * 16 * kRowBytes, kAHalf, 1024)
                             : desc_sw128(at + kk * 32, 16, 1024);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint32_t bt = st + kABytes + m * kBBytes;
        const uint64_t db = BKM ? desc_sw128(bt + kk * 32, 16, 1024)
                                : desc_sw128(bt + kk * 16 * kRowBytes, kBHalf, 1024);
        wgmma_ss<BKM ? 0 : 1, RK ? 1 : 0>(acc[m], da, db, 1);
      }
    }
    wg_commit();
    wg_wait<1>();  // the step before is done: release its stage
    if (i > 0 && lane == 0) mbar_arrive(empty + 8 * ((j - 1) % kStages));
  }
  wg_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);
  if (i > 0 && lane == 0) mbar_arrive(empty + 8 * ((j0 + i - 1) % kStages));
  return j0 + i;
}

// RK: a consumer's 64 rows of expert e's (M, N) gradient (rows row0 ..,
// columns n0 .. of acc[0] and, beside them or in the second matrix, of
// acc[1]) out through shared memory: each accumulator as bf16 into the
// consumer's 16 KB staging, two 64 x 64 boxes in the 128-byte swizzle
// (a quad's 8-column groups land in distinct banks), then two TMA stores
// that run on while the consumers go on to the next tile; the staging is
// written again once they have read it.  The stores clip rows and
// columns past the gradient's edges
template <bool SAME>
__device__ __forceinline__ void store_tile(const float (&acc)[2][64], const CUtensorMap* to0,
                                           const CUtensorMap* to1, uint32_t out, int e,
                                           int row0, int n0, int w, int t128) {
  const int lane = t128 % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    if (t128 == 0) bulk_wait_read<0>();  // the staging's last stores have read it
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + w) : "memory");
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int rr = 16 * (t128 / 32) + g + 8 * hr;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const uint32_t at = out + (i / 8) * kBHalf + rr * kRowBytes +
                            (((i % 8) ^ (rr % 8)) << 4) + 4 * t;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                     "r"(pack_bf16(acc[m][4 * i + 2 * hr], acc[m][4 * i + 2 * hr + 1]))
                     : "memory");
      }
    }
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + w) : "memory");
    if (t128 == 0) {
      const CUtensorMap* map = SAME && m ? to1 : to0;
      const int col = n0 + (SAME ? 0 : BT * m);
      tma_store_3d(map, out, col, row0, e);
      tma_store_3d(map, out + kBHalf, col + 64, row0, e);
      bulk_commit();
    }
  }
}

// a tile's epilogue (not RK: store_tile): this consumer's rows r0, r0 + 8
// of the expert's slots
template <int EPI>
__device__ __forceinline__ void epilogue(const Args& p, const float (&acc)[2][64], int e,
                                         int n0, int r0, bool active, int lane) {
  const int t = lane % 4;
  if (EPI == kBwdUp) {
    // H, DG, DU of the occupied rows; HT: each row's share of <DY, y_s>
    // over these columns (the quad's lanes hold the row), added into dw
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + 8 * hr;
      const bool occ = active && occupied(p, e, r);
      const size_t slot = (size_t)e * p.C + r;
      const float wv = occ && p.s_w != nullptr ? p.s_w[slot] : 1.f;
      // the row's DHu first, all loads in flight together (the stores
      // below could alias them for all the compiler knows)
      float2 dhu_row[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int n = n0 + 8 * i + 2 * t;
        dhu_row[i] = occ && n < p.N
                         ? __ldg(reinterpret_cast<const float2*>(p.in_f32 + slot * p.N + n))
                         : make_float2(0.f, 0.f);
      }
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int n = n0 + 8 * i + 2 * t;
        if (!occ || n >= p.N) continue;
        const float2 dhu2 = dhu_row[i];
        float hv[2], gd[2], ud[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float gv = acc[0][4 * i + 2 * hr + u], uv = acc[1][4 * i + 2 * hr + u];
          const float dhu = u ? dhu2.y : dhu2.x;
          const float sg = 1.0f / (1.0f + expf(-gv));
          const float a = gv * sg;
          hv[u] = __bfloat162float(__float2bfloat16_rn(a * uv));
          part += dhu * hv[u];
          const float dh = wv * dhu;
          ud[u] = dh * a;
          gd[u] = dh * uv * sg * (1.0f + gv * (1.0f - sg));
        }
        *reinterpret_cast<uint32_t*>(p.out_bf16 + slot * p.N + n) = pack_bf16(hv[0], hv[1]);
        *reinterpret_cast<uint32_t*>(p.out2_bf16 + slot * p.N + n) = pack_bf16(gd[0], gd[1]);
        *reinterpret_cast<uint32_t*>(p.out3_bf16 + slot * p.N + n) = pack_bf16(ud[0], ud[1]);
      }
      if (p.dw != nullptr) {
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        if (occ && t == 0) atomicAdd(p.dw + slot, part);
      }
    }
    return;
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 8 * hr;
    if (r >= p.C) continue;
    const bool occ = active && occupied(p, e, r);
    const size_t slot = (size_t)e * p.C + r;
    if (EPI == kUp) {
      if (!occ) continue;
      bf16* const dst = p.out_bf16 + slot * p.N;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int n = n0 + 8 * i + 2 * t;
        if (n >= p.N) continue;
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float gv = acc[0][4 * i + 2 * hr + u], uv = acc[1][4 * i + 2 * hr + u];
          v[u] = gv * (1.0f / (1.0f + expf(-gv))) * uv;
        }
        *reinterpret_cast<uint32_t*>(dst + n) = pack_bf16(v[0], v[1]);
      }
    } else if (EPI == kDHu) {
      if (!occ) continue;
      float* const dst = p.out_f32 + slot * p.N;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int n = n0 + BT * m + 8 * i + 2 * t;
          if (n < p.N)
            *reinterpret_cast<float2*>(dst + n) =
                make_float2(acc[m][4 * i + 2 * hr], acc[m][4 * i + 2 * hr + 1]);
        }
    } else if (EPI == kDxStore) {  // occupied rows into their own rows of dx
      if (!occ) continue;
      bf16* const dst = p.out_bf16 + (size_t)p.s_rows[slot] * p.N;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int n = n0 + BT * m + 8 * i + 2 * t;
          if (n < p.N)
            *reinterpret_cast<uint32_t*>(dst + n) =
                pack_bf16(acc[m][4 * i + 2 * hr], acc[m][4 * i + 2 * hr + 1]);
        }
    } else if (EPI == kDownStore) {
      bf16* const dst = p.out_bf16 + slot * p.N;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int n = n0 + BT * m + 8 * i + 2 * t;
          if (n >= p.N) continue;
          *reinterpret_cast<uint32_t*>(dst + n) =
              occ ? pack_bf16(acc[m][4 * i + 2 * hr], acc[m][4 * i + 2 * hr + 1]) : 0u;
        }
    } else {  // kDownScatter, kDxScatter
      if (!occ) continue;
      const int tok = p.s_rows[slot];
      if (tok < 0 || tok >= p.s_nrows) continue;
      const float wv = EPI == kDownScatter ? p.s_w[slot] : 1.f;
      float* const dst = p.out_f32 + (size_t)tok * p.N;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int n = n0 + BT * m + 8 * i + 2 * t;
          if (n >= p.N) continue;
          atomicAdd(reinterpret_cast<float2*>(dst + n),
                    make_float2(wv * acc[m][4 * i + 2 * hr], wv * acc[m][4 * i + 2 * hr + 1]));
        }
    }
  }
}

// One block of pass EPI: the producer warpgroup, two consumer warpgroups and
// the pass's epilogue.  ta0 / ta1: A (ta1 the second source of a split
// pass), tb0 / tb1: the weight tiles (B) as the pass pairs them.  A block
// takes one tile (x: N, y: rows, z: expert); a RK pass's blocks are
// persistent, each walking tiles blockIdx.x, + gridDim.x, ... of E x tm x
// tn (N fastest, then M, then the expert), so that the producer fills the
// next tile's stages while the consumers store this one's
template <int EPI, bool GATHER>
__device__ __forceinline__ void tile_body(const CUtensorMap* ta0, const CUtensorMap* ta1,
                                          const CUtensorMap* tb0, const CUtensorMap* tb1,
                                          const CUtensorMap* to0, const CUtensorMap* to1,
                                          const Args& p) {
  constexpr bool RK = rows_k<EPI>(), SPLIT = split_k<EPI>(), SAME = same_cols<EPI>();
  constexpr int BNB = block_cols<EPI>();
  const int tid = threadIdx.x;
  const int tiles = RK ? p.E * p.tm * p.tn : 1, stride = RK ? gridDim.x : 1;
  const int first = RK ? blockIdx.x : 0;
  int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BNB;
  const auto place = [&](int tl) {
    if (RK) {
      n0 = tl % p.tn * BNB;
      m0 = tl / p.tn % p.tm * BM;
      e = tl / (p.tn * p.tm);
    }
  };

  // which consumers' 64 rows hold an occupied row (RK: the rows are the
  // gradient's, all live)
  bool act0 = true, act1 = true;
  if (!RK) {
    const bool occ_row = tid < BM && occupied(p, e, m0 + tid);
    act0 = __syncthreads_or(occ_row && tid < 64);
    act1 = __syncthreads_or(occ_row && tid >= 64);
    if (!act0 && !act1) {  // unoccupied tile: no loads, no products
      if (EPI == kDownStore)
        for (int i = tid; i < BM * (BNB / 8); i += kThreads) {
          const int r = m0 + i / (BNB / 8), n = n0 + (i % (BNB / 8)) * 8;
          if (r < p.C && n < p.N)
            *reinterpret_cast<uint4*>(p.out_bf16 + ((size_t)e * p.C + r) * p.N + n) =
                make_uint4(0, 0, 0, 0);
        }
      return;
    }
  }

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms want 1024-byte alignment
  const uint32_t full = base + kOffBar, empty = full + 8 * kStages;
  const int nkh = (p.K + BK - 1) / BK;  // K steps of a source (RK: from the counts)
  const int nk = SPLIT ? 2 * nkh : nkh;

  if (tid == 0) {
    if (!GATHER) prefetch_tensormap(ta0);
    if (SPLIT) prefetch_tensormap(ta1);
    prefetch_tensormap(tb0);
    if (SAME || SPLIT) prefetch_tensormap(tb1);
    if (RK) prefetch_tensormap(to0);
    if (RK && SAME) prefetch_tensormap(to1);
    for (int s = 0; s < kStages; ++s) {
      // TMA: the producer's expect_tx; gathered: its 32 lanes arrive too
      mbar_init(full + 8 * s, GATHER ? 33 : 1);
      mbar_init(empty + 8 * s, 4 * (int(act0) + int(act1)));  // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 0) {
    // ------------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (tid < (GATHER ? 32 : 1)) {
      int j = 0;
      for (int tl = first; tl < tiles; tl += stride) {
        place(tl);
        j = produce<EPI, GATHER>(ta0, ta1, tb0, tb1, p, base, full, empty, e, m0, n0, act0,
                                 act1, nkh, nk, j, tid);
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int w = wg - 1;  // consumer 0 / 1: tile rows 64w .. 64w + 63
  const bool active = w ? act1 : act0;
  const int t128 = tid % 128;
  const int lane = t128 % 32;
  float acc[2][64];
  int j = 0;
  for (int tl = first; tl < tiles; tl += stride) {
    place(tl);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[m][i] = 0.f;
    if (active) j = consume<EPI>(acc, p, base, full, empty, e, w, nk, j, t128);
    if (RK)
      store_tile<SAME>(acc, to0, to1, base + kOffOut + w * kOutBytes, e, m0 + 64 * w, n0, w,
                       t128);
    else  // this thread's rows: r0, r0 + 8 (accumulator row group lane / 4)
      epilogue<EPI>(p, acc, e, n0, m0 + 64 * w + 16 * (t128 / 32) + lane / 4, active, lane);
  }
  if (RK && t128 == 0) bulk_wait<0>();  // the last stores are out
}

// the forwards' kernel
template <int EPI, bool GATHER>
__global__ void __launch_bounds__(kThreads, 1)
    tile_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw0,
                const __grid_constant__ CUtensorMap tw1, const Args p) {
  tile_body<EPI, GATHER>(&ta, &ta, &tw0, &tw1, nullptr, nullptr, p);
}

// a 3-D map over a bf16 (d2, d1, d0) array, d0 contiguous: boxes of 64 x
// box1, the 128-byte swizzle (hopper::encode_3d)
static inline int map_3d(CUtensorMap* map, const void* ptr, long long d0, long long d1,
                         long long d2, int box1) {
  const long long dims[3] = {d0, d1, d2}, str[2] = {2 * d0, 2 * d0 * d1};
  const int box[3] = {64, box1, 1};
  return encode_3d(map, ptr, dims, str, box);
}

// rows of a TMA activation box over C rows an expert
static inline int act_box(int C) { return C >= 64 ? 64 : (C + 7) / 8 * 8; }

// One pass over E experts of C rows: A from ``p.a`` (gathered through
// ``p.a_rows`` when it is set), weights w0 (and w1 for kUp) (E, K, N) bf16.
// Returns cudaGetLastError() after the launch, or the tensor-map encoder's
// CUresult negated if a map could not be made.  static, so that its flag
// below is its own in every source and library (see hopper::encoder).
template <int EPI, bool GATHER = false>
static int launch(Args p, int E, const bf16* w0, const bf16* w1, cudaStream_t st) {
  if (E == 0 || p.C == 0 || p.N == 0) return 0;
  if (p.K == 0) {  // empty products: kUp's h and kDownStore's y are zeros
    if (EPI != kDownScatter)
      cudaMemsetAsync(p.out_bf16, 0, (size_t)E * p.C * p.N * sizeof(bf16), st);
    return static_cast<int>(cudaGetLastError());
  }
  p.a_box = act_box(p.C);
  CUtensorMap ta{}, tw0, tw1;
  int r = 0;
  if (!GATHER) r = map_3d(&ta, p.a, p.K, p.C, E, p.a_box);
  if (r == 0) r = map_3d(&tw0, w0, p.N, p.K, E, BK);
  if (EPI == kUp) {
    if (r == 0) r = map_3d(&tw1, w1, p.N, p.K, E, BK);
  } else {
    tw1 = tw0;  // unread
  }
  if (r != 0) return -r;
  // above 48 KB of dynamic shared memory: once a device
  static unsigned long long raised = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(raised & bit)) {
    cudaFuncSetAttribute(tile_kernel<EPI, GATHER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmem);
    raised |= bit;
  }
  constexpr int BNB = block_cols<EPI>();
  const dim3 grid((p.N + BNB - 1) / BNB, (p.C + BM - 1) / BM, E);
  tile_kernel<EPI, GATHER><<<grid, kThreads, kSmem, st>>>(ta, tw0, tw1, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swiglu_tiles
