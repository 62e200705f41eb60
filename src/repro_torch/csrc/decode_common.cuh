// Flash decoding of one query per sequence, in one launch: the body both
// decoding kernels compile from.  decode_attention.cu reads a contiguous
// cache slice (one pos for the batch), decode_attention_paged.cu block
// pools through a table (a pos a sequence); each passes its own Rows, the
// map from a sequence's positions to cache rows, and keeps only that and
// its C entry points.  q (B, H, D) bf16, D 64 or 128; q head h reads kv
// head h / (H / Hkv), H / Hkv 1, 2, 4, 6 or 8; out (B, H, D) bf16,
// normalised, 0 where no position is live.
//
// Bound on an H100: bytes.  Each live position reads a K and a V row of 2 D
// bytes for each kv head (33.6 MB at qwen3-4b's batch 4, 8 kv heads and
// 2048 positions, 10 us at 3.35 TB/s); at 4 query heads a kv head the
// products are ~4 FLOP a byte.  So the design is about bytes in flight:
// - the grid covers every position a sequence may hold: (ns, Hkv, B)
//   blocks, cut into ns chunks by the shapes and the card alone (the
//   wrapper's decode_chunk: one wave of resident blocks, two an SM where
//   the shapes allow it, the busiest SM's share of positions least).  pos
//   is read on the device, so nothing about the launch depends on it and a
//   CUDA graph captures it once.  A block whose chunk starts past the
//   sequence's live positions reads nothing, and the merge skips it;
// - D / 8 lanes hold a row of 2 D bytes, 16 bytes a lane: at D = 128 16
//   lanes and a block's 8 row groups, at D = 64 8 lanes and 16 row groups
//   (musicgen-large); a row group takes kU positions a step.  The rows land by cp.async in a ring of
//   kStages steps in shared memory, kStages - 1 steps ahead of the step
//   being used (up to 32 KB of K and V in flight a block at rep <= 4).  A
//   dead row (past pos, or not backed by the cache) is copied with
//   src-size 0: it reads nothing and lands as zeros, and its score is
//   -inf.  Each lane reads back only the bytes it copied, so the ring
//   needs no barrier: cp.async.wait_group alone orders it;
// - a block serves all rep query heads of its kv head, so each row is read
//   once; a score sums over its row's lanes; the running max, sum and
//   output stay in fp32 registers, P rounding to bf16 before it weights V
//   while the sum takes it in fp32;
// - the row groups merge in shared memory and the block writes its chunk's
//   (max, sum, output).  The last block of a (sequence, kv head) to arrive
//   (an atomic counter) merges the chunks that can hold a live position by
//   log-sum-exp in one pass, the loads of eight chunks in flight at once
//   (four where a thread merges more than four heads), a thread a feature
//   (at D = 64 two threads a feature, each half the heads), divides,
//   writes the output, and sets the counter back to 0 itself, so the next
//   launch, or a graph's next replay, needs no memset.
//
// The head dim D and rep are template parameters: the D = 128
// instantiations at rep 1, 2, 4 and 8 are the kernel as it was before D
// became a parameter, bit for bit; rep 6 (internvl2-26b) takes kU = 2, as
// rep 8 does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 3;                     // steps of the ring
// a chunk is a whole number of the largest step (kGroups * kU positions)
constexpr int kChunkAlign = 32;

// a cache row of head dim D, 16 bytes (8 values) a lane
template <int D>
struct Row {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static constexpr int kLanes = D / 8;               // lanes a cache row
  static constexpr int kGroups = kThreads / kLanes;  // row groups a block
  static constexpr int kBytes = D * 2;               // a K or a V row, bf16
};

// positions a row group takes a step: at D = 128 fewer at rep 6 and 8,
// whose query and output registers take the room; at D = 64 two, which
// with its 16 row groups is 32 positions a step
template <int REP, int D>
struct Step {
  static constexpr int kU = D == 64 ? 2 : (REP <= 4 ? 4 : 2);
  static constexpr int kStepBytes = Row<D>::kGroups * kU * 2 * Row<D>::kBytes;  // K and V
  // the ring, which also holds the row groups' outputs after the loop
  static constexpr int kOutBytes = Row<D>::kGroups * REP * D * 4;
  static constexpr int kRingBytes =
      kStages * kStepBytes > kOutBytes ? kStages * kStepBytes : kOutBytes;
};
static_assert(kChunkAlign % (Row<128>::kGroups * Step<1, 128>::kU) == 0 &&
                  kChunkAlign % (Row<128>::kGroups * Step<8, 128>::kU) == 0 &&
                  kChunkAlign % (Row<64>::kGroups * Step<1, 64>::kU) == 0 &&
                  kChunkAlign % (Row<64>::kGroups * Step<8, 64>::kU) == 0,
              "a chunk is whole steps");

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* pos;     // contiguous: 0-d, global; paged: (B,)
  const int* tables;  // paged: (B, nb) pool block ids
  float* part_o;      // (B, H, ns, D): each chunk's unnormalised output
  float* part_m;      // (B, H, ns): its max, base-2 domain
  float* part_l;      // (B, H, ns): its sum
  int* arrivals;      // (B, Hkv): blocks done, 0 between launches
  bf16* out;
  int H, Hkv, ns, chunk;
  int S;              // positions a sequence may hold (paged: nb * bs)
  int start;          // contiguous: the slice's first global position
  int NB, bs, nb;     // paged: pool blocks, rows a block, table columns
  float scale_log2;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void to_float8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// the sum over the LANES lanes of a row group (xor offsets below LANES
// stay in the group)
template <int LANES>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes global -> shared, asynchronous; zero-filled, reading nothing,
// where !live
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A Rows<D> maps sequence b's positions 0 .. S - 1 to cache rows:
//   static int n_live(p, b): positions below it may be live, the same
//     number in every block of sequence b;
//   Rows(p, b, kh, gl, j0): this lane's view of the chunk from j0, made
//     by every thread of a block whose chunk holds a live position (it
//     may stage with a barrier);
//   kb, vb: this lane's 16 bytes of kv head kh's K and V at offset 0;
//   at<U>(j, j1, off): the element offsets of positions j .. j + U - 1
//     and, as bits, those that are live (below j1 and backed by a row);
//   live<U>(j, j1, ring): those bits again when the step is scored, ring
//     being what at<U> returned for it.

// this lane's 16 bytes of the K and V rows of positions j .. j + U - 1
// into its slots of a ring step; returns their live bits (a dead row
// lands as zeros and is scored -inf)
template <int U, int kRowBytes, class Rows>
__device__ __forceinline__ unsigned copy_rows(unsigned char* slot, const Rows& rows, int j,
                                              int j1) {
  long long off[U];
  const unsigned live = rows.template at<U>(j, j1, off);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool l = (live >> u) & 1u;
    cp_async16(slot + (2 * u) * kRowBytes, rows.kb + off[u], l);
    cp_async16(slot + (2 * u + 1) * kRowBytes, rows.vb + off[u], l);
  }
  return live;
}

template <int REP, int D, class Rows>
__global__ void __launch_bounds__(kThreads) decode_kernel(Params p) {
  constexpr int kRowLanes = Row<D>::kLanes, kGroups = Row<D>::kGroups;
  constexpr int kRowBytes = Row<D>::kBytes;
  constexpr int U = Step<REP, D>::kU;
  constexpr int kStep = kGroups * U;  // positions a block takes a step
  constexpr int kStepBytes = Step<REP, D>::kStepBytes;
  constexpr unsigned kBits = (1u << U) - 1;
  extern __shared__ __align__(16) unsigned char ring[];
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, grp = tid / kRowLanes, gl = tid % kRowLanes;
  const long long bh0 = (long long)b * p.H + kh * REP;
  uint4 qraw[REP];  // in flight beside pos
#pragma unroll
  for (int r = 0; r < REP; ++r)
    qraw[r] = __ldg(reinterpret_cast<const uint4*>(p.q + (bh0 + r) * D + 8 * gl));
  const int n_live = Rows::n_live(p, b);
  const int j0 = split * p.chunk;
  const int j1 = min(j0 + p.chunk, n_live);
  const int ns = p.ns;

  if (j0 < j1) {
    const Rows rows(p, b, kh, gl, j0);
    float q[REP][8], o[REP][8], m[REP], l[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      to_float8(qraw[r], q[r]);
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) o[r][i] = 0.f;
    }
    // this lane's bytes of a ring step: its group's U positions, K and V
    unsigned char* const mine = ring + (grp * U * 2) * kRowBytes + 16 * gl;
    const int n_steps = (j1 - j0 + kStep - 1) / kStep;  // uniform
    unsigned live = 0;  // the live bits of the ring's steps, U a slot
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < n_steps)
        live |= copy_rows<U, kRowBytes>(mine + i * kStepBytes, rows,
                                        j0 + i * kStep + grp * U, j1)
                << (i * U);
      cp_async_commit();
    }
    for (int st = 0; st < n_steps; ++st) {
      cp_async_wait<kStages - 2>();  // step st has landed
      // refill the slot step st - 1 used, which this lane has read
      const int ahead = st + kStages - 1;
      if (ahead < n_steps) {
        const int sh = (ahead % kStages) * U;
        live = (live & ~(kBits << sh)) |
               (copy_rows<U, kRowBytes>(mine + (ahead % kStages) * kStepBytes, rows,
                                        j0 + ahead * kStep + grp * U, j1)
                << sh);
      }
      cp_async_commit();
      const unsigned char* const cur = mine + (st % kStages) * kStepBytes;
      const unsigned lv = rows.template live<U>(j0 + st * kStep + grp * U, j1,
                                                live >> ((st % kStages) * U));
      float s[REP][U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[8];
        to_float8(*reinterpret_cast<const uint4*>(cur + (2 * u) * kRowBytes), kf);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) a = fmaf(q[r][i], kf[i], a);
          s[r][u] = a;
        }
      }
      float ms[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float mx = m[r];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          // every lane shuffles: the two row groups of a warp may differ
          // in which of their positions are live
          const float t = row_sum<kRowLanes>(s[r][u]) * p.scale_log2;
          s[r][u] = ((lv >> u) & 1u) ? t : -INFINITY;
          mx = fmaxf(mx, s[r][u]);
        }
        // a group with no live position yet keeps m = -inf, l = 0, o = 0
        ms[r] = (mx == -INFINITY) ? 0.f : mx;
        const float corr = exp2f(m[r] - ms[r]);
        l[r] *= corr;
#pragma unroll
        for (int i = 0; i < 8; ++i) o[r][i] *= corr;
        m[r] = mx;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[8];
        to_float8(*reinterpret_cast<const uint4*>(cur + (2 * u + 1) * kRowBytes), vf);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float pe = exp2f(s[r][u] - ms[r]);
          l[r] += pe;
          const float pb = bf16_round(pe);
#pragma unroll
          for (int i = 0; i < 8; ++i) o[r][i] = fmaf(pb, vf[i], o[r][i]);
        }
      }
    }

    // the row groups' (max, sum, output) merged into the chunk's; the
    // outputs in the ring, once every lane is done with it
    __shared__ float sm_m[kGroups][REP], sm_l[kGroups][REP];
    static_assert(kGroups * REP * D * 4 <= Step<REP, D>::kRingBytes, "ring too small");
    float (*sm_o)[REP][D] = reinterpret_cast<float (*)[REP][D]>(ring);
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (gl == 0) {
        sm_m[grp][r] = m[r];
        sm_l[grp][r] = l[r];
      }
      float4* dst = reinterpret_cast<float4*>(&sm_o[grp][r][8 * gl]);
      dst[0] = make_float4(o[r][0], o[r][1], o[r][2], o[r][3]);
      dst[1] = make_float4(o[r][4], o[r][5], o[r][6], o[r][7]);
    }
    __syncthreads();
    for (int idx = tid; idx < REP * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      float M = -INFINITY;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) M = fmaxf(M, sm_m[g][r]);
      float L = 0.f, O = 0.f;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float c = (sm_m[g][r] == -INFINITY) ? 0.f : exp2f(sm_m[g][r] - M);
        L += sm_l[g][r] * c;
        O += sm_o[g][r][d] * c;
      }
      const long long bh = bh0 + r;
      p.part_o[(bh * ns + split) * D + d] = O;
      if (d == 0) {
        p.part_m[bh * ns + split] = M;
        p.part_l[bh * ns + split] = L;
      }
    }
  } else {
    // nothing of this chunk is live: it writes m = -inf, l = 0, o = 0,
    // which the merge never reads (without this branch nvcc lays out the
    // live path otherwise, and it ran 2-7% slower on an H100)
    for (int idx = tid; idx < REP * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const long long bh = bh0 + r;
      p.part_o[(bh * ns + split) * D + d] = 0.f;
      if (d == 0) {
        p.part_m[bh * ns + split] = -INFINITY;
        p.part_l[bh * ns + split] = 0.f;
      }
    }
  }

  // arrive; the last of the (sequence, kv head)'s ns blocks merges
  int* const counter = p.arrivals + (long long)b * p.Hkv + kh;
  __threadfence();
  __syncthreads();
  int arrived = 0;
  if (tid == 0) arrived = atomicAdd(counter, 1);
  if (!__syncthreads_or(tid == 0 && arrived == ns - 1)) return;
  __threadfence();
  // one pass over the chunks that hold a live position (the others add
  // nothing), a running log-sum-exp merge: thread tid takes feature d =
  // tid % D of kRH heads, r0, r0 + kSplit, ... (at D = 128 all rep heads;
  // at D = 64 the threads of either half take every other head), and the
  // loads of several chunks are in flight at once (the chunks' rows lie in
  // L2)
  constexpr int kSplit = kThreads / D;              // threads a feature
  constexpr int kRH = (REP + kSplit - 1) / kSplit;  // heads a thread merges
  static_assert(kThreads % D == 0, "whole threads a feature");
  const int d = kSplit == 1 ? tid : tid % D;
  const int r0 = kSplit == 1 ? 0 : tid / D;
  float M[kRH], L[kRH], O[kRH];
#pragma unroll
  for (int i = 0; i < kRH; ++i) {
    M[i] = -INFINITY;
    L[i] = O[i] = 0.f;
  }
  const float* pm = p.part_m + bh0 * ns;  // (REP, ns): the heads are neighbours
  const float* pl = p.part_l + bh0 * ns;
  const float* po = p.part_o + bh0 * ns * D + d;
  // chunks whose loads are issued together: 8, 4 above four heads a
  // thread (registers)
  constexpr int kBatch = kRH <= 4 ? 8 : 4;
  for (int c0 = 0; c0 * p.chunk < n_live; c0 += kBatch) {
    float mc[kBatch][kRH], lc[kBatch][kRH], oc[kBatch][kRH];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
#pragma unroll
      for (int i = 0; i < kRH; ++i) {
        // chunk c holds a live position when c * chunk < n_live; a chunk
        // past them merges as nothing, as does a head past rep
        const int r = r0 + kSplit * i;
        const bool in = (c0 + j) * p.chunk < n_live;
        const bool use = in && (kSplit == 1 || r < REP);
        const long long c = r * ns + c0 + j;
        mc[j][i] = use ? __ldcg(pm + c) : -INFINITY;
        lc[j][i] = use ? __ldcg(pl + c) : 0.f;
        oc[j][i] = use ? __ldcg(po + c * D) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
#pragma unroll
      for (int i = 0; i < kRH; ++i) {
        const float mn = fmaxf(M[i], mc[j][i]);
        const float ms = (mn == -INFINITY) ? 0.f : mn;
        const float a = exp2f(M[i] - ms), w = exp2f(mc[j][i] - ms);  // 0 for -inf
        L[i] = L[i] * a + lc[j][i] * w;
        O[i] = O[i] * a + oc[j][i] * w;
        M[i] = mn;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRH; ++i) {
    const int r = r0 + kSplit * i;
    if (kSplit == 1 || r < REP)
      p.out[(bh0 + r) * D + d] = __float2bfloat16_rn(O[i] / (L[i] == 0.f ? 1.f : L[i]));
  }
  if (tid == 0) *counter = 0;
}

// the ring's dynamic shared memory, allowed once (above 48 KB it must be)
template <int REP, int D, class Rows>
cudaError_t allow_ring() {
  static cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<REP, D, Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Step<REP, D>::kRingBytes);
  return err;
}

template <int REP, int D, class Rows>
cudaError_t launch_rep(const Params& p, dim3 grid, cudaStream_t s) {
  const cudaError_t err = allow_ring<REP, D, Rows>();
  if (err != cudaSuccess) return err;
  decode_kernel<REP, D, Rows><<<grid, kThreads, Step<REP, D>::kRingBytes, s>>>(p);
  return cudaGetLastError();
}

// the kernel for rep = H / Hkv query heads a kv head, on grid (ns, Hkv, B)
template <int D, class Rows>
int launch_at(const Params& p, int B, cudaStream_t s) {
  const dim3 grid(p.ns, p.Hkv, B);
  cudaError_t err;
  switch (p.H / p.Hkv) {
    case 1: err = launch_rep<1, D, Rows>(p, grid, s); break;
    case 2: err = launch_rep<2, D, Rows>(p, grid, s); break;
    case 4: err = launch_rep<4, D, Rows>(p, grid, s); break;
    case 6: err = launch_rep<6, D, Rows>(p, grid, s); break;
    case 8: err = launch_rep<8, D, Rows>(p, grid, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// the kernel at head dim D (64 or 128) with Rows<D>
template <template <int> class Rows>
int launch(const Params& p, int B, int D, cudaStream_t s) {
  switch (D) {
    case 64: return launch_at<64, Rows<64>>(p, B, s);
    case 128: return launch_at<128, Rows<128>>(p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int REP, int D, class Rows>
int blocks_per_sm_rep() {
  int n = 0;
  if (allow_ring<REP, D, Rows>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_kernel<REP, D, Rows>, kThreads,
                                                    Step<REP, D>::kRingBytes) != cudaSuccess)
    return 0;
  return n;
}

template <int D, class Rows>
int blocks_per_sm_at(int rep) {
  switch (rep) {
    case 1: return blocks_per_sm_rep<1, D, Rows>();
    case 2: return blocks_per_sm_rep<2, D, Rows>();
    case 4: return blocks_per_sm_rep<4, D, Rows>();
    case 6: return blocks_per_sm_rep<6, D, Rows>();
    case 8: return blocks_per_sm_rep<8, D, Rows>();
    default: return 0;
  }
}

// resident blocks an SM holds at rep and head dim D (0 for a rep or D the
// kernel does not take, or on error)
template <template <int> class Rows>
int blocks_per_sm(int rep, int D) {
  switch (D) {
    case 64: return blocks_per_sm_at<64, Rows<64>>(rep);
    case 128: return blocks_per_sm_at<128, Rows<128>>(rep);
    default: return 0;
  }
}

}  // namespace
