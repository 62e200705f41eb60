// decode_attention: flash decoding of one query per sequence over a
// contiguous cache slice, in one launch.  q (B, H, D) bf16, k / v (B, S,
// Hkv, D) bf16 holding global positions [start, start + S), D = 128; pos a
// 0-d int32 on the device, the same for the batch: sequence b attends
// positions start .. pos; q head h reads kv head h / (H / Hkv).  out (B, H,
// D) bf16, normalised, 0 where no position is live.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:67
// decode_attention_pallas (body _dec_kernel :25): every attention layer of
// a serving decode step.  As there (a scalar-prefetch operand, :96), pos is
// read on the device: nothing about the launch depends on it, so a CUDA
// graph captures the launch once and replays it at every position.
//
// Bound on an H100: bytes.  Each live position reads a K and a V row of 256
// bytes for each kv head, 33.6 MB a layer at qwen3-4b's batch 4, 8 kv heads
// and 2048 positions (10 us at 3.35 TB/s); at 4 query heads a kv head the
// products are ~4 FLOP a byte.  So the design is about bytes in flight:
// - the grid covers the whole slice: (ns, Hkv, B) blocks, the slice cut into
//   ns chunks by the shapes and the card alone (the wrapper's decode_chunk:
//   one wave of resident blocks, two an SM where the shapes allow it, the
//   busiest SM's share of positions least).  A block whose chunk starts
//   past pos writes m = -inf, l = 0, o = 0 and leaves at once
//   (decode_attention.py:37);
// - 16 lanes hold a 256-byte row, 16 bytes a lane; a block's 8 row groups
//   take kU positions each a step.  The rows land by cp.async in a ring of
//   kStages steps in shared memory, kStages - 1 steps ahead of the step
//   being used (up to 32 KB of K and V in flight a block at rep <= 4).
//   Each lane reads back only the bytes it copied, so the ring needs no
//   barrier: cp.async.wait_group alone orders it;
// - a block serves all rep query heads of its kv head, so each row is read
//   once (:80-81); a score sums over its row's 16 lanes; the running max,
//   sum and output stay in fp32 registers, P rounding to bf16 before it
//   weights V (:52-54) while the sum takes it in fp32;
// - the row groups merge in shared memory and the block writes its chunk's
//   (max, sum, output).  The last block of a (sequence, kv head) to arrive
//   (an atomic counter) merges the chunks by log-sum-exp in one pass, the
//   loads of eight chunks in flight at once, divides, writes the output,
//   and sets the counter back to 0 itself, so the next launch, or a
//   graph's next replay, needs no memset.
#include "decode_common.cuh"

namespace {

constexpr int kRowLanes = 16;                  // lanes a cache row
constexpr int kGroups = kThreads / kRowLanes;  // row groups a block

constexpr int kStages = 3;                     // steps of the ring
constexpr int kRowBytes = kD * 2;              // a K or a V row, bf16

// positions a row group takes a step: fewer at rep 8, whose query and
// output registers take twice the room
template <int REP>
struct Step {
  static constexpr int kU = REP <= 4 ? 4 : 2;
  static constexpr int kStepBytes = kGroups * kU * 2 * kRowBytes;  // K and V
  // the ring, which also holds the row groups' outputs after the loop
  static constexpr int kOutBytes = kGroups * REP * kD * 4;
  static constexpr int kRingBytes =
      kStages * kStepBytes > kOutBytes ? kStages * kStepBytes : kOutBytes;
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* pos;
  float* part_o;   // (B, H, ns, D): each chunk's unnormalised output
  float* part_m;   // (B, H, ns): its max, base-2 domain
  float* part_l;   // (B, H, ns): its sum
  int* arrivals;   // (B, Hkv): blocks done, 0 between launches
  bf16* out;
  int S, H, Hkv, start, ns, chunk;
  float scale_log2;
};

__device__ __forceinline__ void to_float8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// the sum over the 16 lanes of a row group (xor offsets below 16 stay in
// the half warp)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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

// this lane's 16 bytes of the K and V rows of positions j .. j + U - 1
// into its slots of a ring step (zeros at or past j1, never read there)
template <int U>
__device__ __forceinline__ void copy_rows(unsigned char* slot, const bf16* kb, const bf16* vb,
                                          long long row, int j, int j1) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool live = j + u < j1;
    const long long off = live ? (j + u) * row : 0;
    cp_async16(slot + (2 * u) * kRowBytes, kb + off, live);
    cp_async16(slot + (2 * u + 1) * kRowBytes, vb + off, live);
  }
}

template <int REP>
__global__ void __launch_bounds__(kThreads) decode_kernel(Params p) {
  constexpr int U = Step<REP>::kU;
  constexpr int kStep = kGroups * U;  // positions a block takes a step
  constexpr int kStepBytes = Step<REP>::kStepBytes;
  extern __shared__ __align__(16) unsigned char ring[];
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, grp = tid / kRowLanes, gl = tid % kRowLanes;
  const long long bh0 = (long long)b * p.H + kh * REP;
  uint4 qraw[REP];  // in flight beside pos
#pragma unroll
  for (int r = 0; r < REP; ++r)
    qraw[r] = __ldg(reinterpret_cast<const uint4*>(p.q + (bh0 + r) * kD + 8 * gl));
  const int n_live = min(max(__ldg(p.pos) - p.start + 1, 0), p.S);
  const int j0 = split * p.chunk;
  const int j1 = min(j0 + p.chunk, n_live);
  const int ns = p.ns;

  if (j0 < j1) {
    const long long row = (long long)p.Hkv * kD;  // elements between positions
    const long long base = ((long long)b * p.S * p.Hkv + kh) * kD + 8 * gl;
    const bf16* kb = p.k + base;
    const bf16* vb = p.v + base;
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
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < n_steps)
        copy_rows<U>(mine + i * kStepBytes, kb, vb, row, j0 + i * kStep + grp * U, j1);
      cp_async_commit();
    }
    for (int st = 0; st < n_steps; ++st) {
      cp_async_wait<kStages - 2>();  // step st has landed
      // refill the slot step st - 1 used, which this lane has read
      const int ahead = st + kStages - 1;
      if (ahead < n_steps)
        copy_rows<U>(mine + (ahead % kStages) * kStepBytes, kb, vb, row,
                     j0 + ahead * kStep + grp * U, j1);
      cp_async_commit();
      const unsigned char* const cur = mine + (st % kStages) * kStepBytes;
      const int jc = j0 + st * kStep + grp * U;  // this group's first position
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
          const float t = row_sum(s[r][u]) * p.scale_log2;
          s[r][u] = (jc + u < j1) ? t : -INFINITY;
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
    static_assert(kGroups * REP * kD * 4 <= Step<REP>::kRingBytes, "ring too small");
    float (*sm_o)[REP][kD] = reinterpret_cast<float (*)[REP][kD]>(ring);
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
    for (int idx = tid; idx < REP * kD; idx += kThreads) {
      const int r = idx / kD, d = idx % kD;
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
      p.part_o[(bh * ns + split) * kD + d] = O;
      if (d == 0) {
        p.part_m[bh * ns + split] = M;
        p.part_l[bh * ns + split] = L;
      }
    }
  } else {
    // nothing of this chunk is live: it contributes exactly nothing
    for (int idx = tid; idx < REP * kD; idx += kThreads) {
      const int r = idx / kD, d = idx % kD;
      const long long bh = bh0 + r;
      p.part_o[(bh * ns + split) * kD + d] = 0.f;
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
  // one pass over the chunks, a running log-sum-exp merge: thread d takes
  // feature d of all rep heads, and the loads of several chunks are in
  // flight at once (the chunks' rows lie in L2)
  static_assert(kThreads == kD, "a thread a feature");
  float M[REP], L[REP], O[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    M[r] = -INFINITY;
    L[r] = O[r] = 0.f;
  }
  const float* pm = p.part_m + bh0 * ns;  // (REP, ns): the heads are neighbours
  const float* pl = p.part_l + bh0 * ns;
  const float* po = p.part_o + bh0 * ns * kD + tid;
  // chunks whose loads are issued together: 8, 4 at rep 8 (registers)
  constexpr int kBatch = REP <= 4 ? 8 : 4;
  for (int c0 = 0; c0 < ns; c0 += kBatch) {
    float mc[kBatch][REP], lc[kBatch][REP], oc[kBatch][REP];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const bool in = c0 + j < ns;  // a chunk past ns merges as nothing
        const long long c = r * ns + c0 + j;
        mc[j][r] = in ? __ldcg(pm + c) : -INFINITY;
        lc[j][r] = in ? __ldcg(pl + c) : 0.f;
        oc[j][r] = in ? __ldcg(po + c * kD) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float mn = fmaxf(M[r], mc[j][r]);
        const float ms = (mn == -INFINITY) ? 0.f : mn;
        const float a = exp2f(M[r] - ms), w = exp2f(mc[j][r] - ms);  // 0 for -inf
        L[r] = L[r] * a + lc[j][r] * w;
        O[r] = O[r] * a + oc[j][r] * w;
        M[r] = mn;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < REP; ++r)
    p.out[(bh0 + r) * kD + tid] = __float2bfloat16_rn(O[r] / (L[r] == 0.f ? 1.f : L[r]));
  if (tid == 0) *counter = 0;
}

// the ring's dynamic shared memory, allowed once (above 48 KB it must be)
template <int REP>
cudaError_t allow_ring() {
  static cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<REP>, cudaFuncAttributeMaxDynamicSharedMemorySize, Step<REP>::kRingBytes);
  return err;
}

template <int REP>
cudaError_t launch(const Params& p, dim3 grid, cudaStream_t s) {
  const cudaError_t err = allow_ring<REP>();
  if (err != cudaSuccess) return err;
  decode_kernel<REP><<<grid, kThreads, Step<REP>::kRingBytes, s>>>(p);
  return cudaGetLastError();
}

template <int REP>
int blocks_per_sm() {
  int n = 0;
  if (allow_ring<REP>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_kernel<REP>, kThreads,
                                                    Step<REP>::kRingBytes) != cudaSuccess)
    return 0;
  return n;
}

}  // namespace

// Resident blocks an SM holds of the kernel for rep query heads a kv head
// (0 for a rep it does not take, or on error).
extern "C" int decode_attention_blocks_per_sm(int rep) {
  switch (rep) {
    case 1: return blocks_per_sm<1>();
    case 2: return blocks_per_sm<2>();
    case 4: return blocks_per_sm<4>();
    case 8: return blocks_per_sm<8>();
    default: return 0;
  }
}

// q (B, H, 128), k / v (B, S, Hkv, 128) bf16, contiguous; pos a 0-d int32
// on the device, global; start the slice's first global position; ns
// chunks of chunk positions cover S (ns * chunk >= S, ns >= 1); part_o
// (B, H, ns, 128) and part_ml (2, B, H, ns) the wrapper's fp32 scratch;
// arrivals (B * Hkv) int32, zero, and zero again after the launch; out (B,
// H, 128) bf16.  H / Hkv must be 1, 2, 4 or 8.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* pos, void* part_o, void* part_ml,
                                       void* arrivals, void* out, int B, int S, int H, int Hkv,
                                       int start, int ns, int chunk, void* stream) {
  if (ns < 1 || (long long)ns * chunk < S) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.pos = static_cast<const int*>(pos);
  p.part_o = static_cast<float*>(part_o);
  p.part_m = static_cast<float*>(part_ml);
  p.part_l = p.part_m + (long long)B * H * ns;
  p.arrivals = static_cast<int*>(arrivals);
  p.out = static_cast<bf16*>(out);
  p.S = S;
  p.H = H;
  p.Hkv = Hkv;
  p.start = start;
  p.ns = ns;
  p.chunk = chunk;
  p.scale_log2 = kLog2e / sqrtf((float)kD);
  const dim3 grid(ns, Hkv, B);
  cudaError_t err;
  switch (H / Hkv) {
    case 1: err = launch<1>(p, grid, s); break;
    case 2: err = launch<2>(p, grid, s); break;
    case 4: err = launch<4>(p, grid, s); break;
    case 8: err = launch<8>(p, grid, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
