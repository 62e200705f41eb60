// Shared tile loop of the grouped expert kernels (grouped_matmul.cu,
// grouped_swiglu.cu, grouped_swiglu_db.cu, gather_swiglu_scatter.cu).
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
constexpr int kGatherLag = 3;       // stages a gathering producer keeps open
static_assert(kStages > kGatherLag, "the gathering producer needs the lag");

enum Epilogue { kUp = 0, kDownStore = 1, kDownScatter = 2 };

// output columns a block: kUp's two weight tiles are gate and up of the
// same columns, kDown's are two neighbouring column tiles
template <int EPI>
__host__ __device__ constexpr int block_cols() {
  return EPI == kUp ? BT : 2 * BT;
}

struct Args {
  const bf16* a;       // A rows: x / x_ext (kUp) or h (kDown*)
  const int* a_rows;   // gather table, indexed e * C + r (gathering kUp)
  int a_nrows;         // rows in A's table (gathered indices are clamped)
  const int* cnt;      // (E * B,) occupied prefix of each sub-bucket
  int C, B, Cg;        // rows an expert = B sub-buckets of Cg
  int K, N;            // reduce, output columns
  int a_box;           // rows of a TMA A box: min(64, C rounded up to 8)
  bf16* out_bf16;      // kUp: h (E*C, N);  kDownStore: y (E*C, N)
  float* out_f32;      // kDownScatter: (s_nrows, N) fp32, atomically added
  const int* s_rows;   // kDownScatter: token row per slot
  const float* s_w;    // kDownScatter: combine weight per slot
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

// the producer: one thread (TMA rows) or one warp (gathered rows) filling
// the ring for the consumers marked in act0 / act1
template <int EPI, bool GATHER>
__device__ __forceinline__ void produce(const CUtensorMap* ta, const CUtensorMap* tw0,
                                        const CUtensorMap* tw1, const Args& p, uint32_t base,
                                        uint32_t full, uint32_t empty, int e, int m0, int n0,
                                        bool act0, bool act1, int nk, int lane) {
  const uint32_t a_bytes = GATHER ? 0u : (int(act0) + int(act1)) * p.a_box * kRowBytes;
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
  for (int j = 0; j < nk; ++j) {
    if (GATHER && j >= kGatherLag) {  // stage j - lag has landed: mark it full
      cp_async_wait<kGatherLag - 1>();
      fence_proxy_async();
      mbar_arrive(full + 8 * ((j - kGatherLag) % kStages));
    }
    const int s = j % kStages;
    if (j >= kStages) mbar_wait(empty + 8 * s, ((j / kStages) - 1) & 1);
    const uint32_t st = base + s * kStageBytes;
    const int k0 = j * BK;
    if (lane == 0) {
      mbar_expect_tx(full + 8 * s, a_bytes + 2 * kBBytes);
      if (!GATHER) {
        if (act0) tma_load_3d(st, ta, full + 8 * s, k0, m0, e);
        if (act1) tma_load_3d(st + kAHalf, ta, full + 8 * s, k0, m0 + 64, e);
      }
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          tma_load_3d(st + kABytes + w * kBBytes + half * kBHalf,
                      EPI == kUp && w ? tw1 : tw0, full + 8 * s,
                      n0 + (EPI == kUp ? 0 : BT * w) + 64 * half, k0, e);
    }
    if (GATHER) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!(q < 2 ? act0 : act1)) continue;
        const int lr = lane + 32 * q;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int k = k0 + 8 * c;
          const bool live = rowp[q] != nullptr && k < p.K;
          cp_async_16(st + lr * kRowBytes + ((c ^ (lr & 7)) << 4),
                      live ? static_cast<const void*>(rowp[q] + k) : p.a, live ? 16 : 0);
        }
      }
      cp_async_commit();
    }
  }
  if (GATHER) {
    cp_async_wait<0>();
    fence_proxy_async();
    for (int j = max(nk - kGatherLag, 0); j < nk; ++j) mbar_arrive(full + 8 * (j % kStages));
  }
}

template <int EPI, bool GATHER>
__global__ void __launch_bounds__(kThreads, 1)
    tile_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw0,
                const __grid_constant__ CUtensorMap tw1, const Args p) {
  constexpr int BNB = block_cols<EPI>();
  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BNB;
  const int tid = threadIdx.x;

  // which consumers' 64 rows hold an occupied row
  const bool occ_row = tid < BM && occupied(p, e, m0 + tid);
  const bool act0 = __syncthreads_or(occ_row && tid < 64);
  const bool act1 = __syncthreads_or(occ_row && tid >= 64);
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

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms want 1024-byte alignment
  const uint32_t full = base + kOffBar, empty = full + 8 * kStages;
  const int nk = (p.K + BK - 1) / BK;

  if (tid == 0) {
    if (!GATHER) prefetch_tensormap(&ta);
    prefetch_tensormap(&tw0);
    if (EPI == kUp) prefetch_tensormap(&tw1);
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
    if (tid < (GATHER ? 32 : 1))
      produce<EPI, GATHER>(&ta, &tw0, &tw1, p, base, full, empty, e, m0, n0, act0, act1, nk,
                           tid);
    return;
  }

  // ---------------------------------------------------------- consumers --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int w = wg - 1;  // consumer 0 / 1: tile rows 64w .. 64w + 63
  const bool active = w ? act1 : act0;
  const int t128 = tid % 128;
  const int lane = t128 % 32;
  const int g = lane / 4, t = lane % 4;               // accumulator row group, column pair
  const int r0 = m0 + 64 * w + 16 * (t128 / 32) + g;  // this thread's rows: r0, r0 + 8

  float acc[2][64];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[m][i] = 0.f;

  if (active) {
    for (int j = 0; j < nk; ++j) {
      const int s = j % kStages;
      mbar_wait(full + 8 * s, (j / kStages) & 1);
      const uint32_t st = base + s * kStageBytes;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = desc_sw128(st + w * kAHalf + kk * 32, 16, 1024);
#pragma unroll
        for (int m = 0; m < 2; ++m)
          wgmma_ss<1>(acc[m], da,
                      desc_sw128(st + kABytes + m * kBBytes + kk * 16 * kRowBytes, kBHalf, 1024),
                      1);
      }
      wg_commit();
      wg_wait<1>();  // the step before is done: release its stage
      if (j > 0 && lane == 0) mbar_arrive(empty + 8 * ((j - 1) % kStages));
    }
    wg_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    if (nk > 0 && lane == 0) mbar_arrive(empty + 8 * ((nk - 1) % kStages));
  }

  // ---------------------------------------------------------- epilogue --
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
    } else {
      if (!occ) continue;
      const int tok = p.s_rows[slot];
      if (tok < 0 || tok >= p.s_nrows) continue;
      const float wv = p.s_w[slot];
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
  p.a_box = p.C >= 64 ? 64 : (p.C + 7) / 8 * 8;
  CUtensorMap ta{}, tw0, tw1;
  const long long wdims[3] = {p.N, p.K, E}, wstr[2] = {2ll * p.N, 2ll * p.N * p.K};
  const int wbox[3] = {64, BK, 1};
  int r = 0;
  if (!GATHER) {
    const long long adims[3] = {p.K, p.C, E}, astr[2] = {2ll * p.K, 2ll * p.K * p.C};
    const int abox[3] = {BK, p.a_box, 1};
    r = encode_3d(&ta, p.a, adims, astr, abox);
  }
  if (r == 0) r = encode_3d(&tw0, w0, wdims, wstr, wbox);
  if (EPI == kUp) {
    if (r == 0) r = encode_3d(&tw1, w1, wdims, wstr, wbox);
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
