// Shared pieces of the two flash-decoding kernels (decode_attention.cu,
// contiguous cache; decode_attention_paged.cu, block pools): the sizes, the
// lane helpers, and the merge kernel that combines the chunks' (max, sum,
// output) by log-sum-exp and divides.  A chunk with no live position
// contributes m = -inf, l = 0, o = 0 and so nothing; a head with no live
// position at all gets 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kD = 128;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKB = 8;       // positions a warp has in flight
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float4 to_float4(uint2 u) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Merges the block's warps' running (max, sum, output) of its REP query
// heads and writes them as chunk `split` of heads bh0 .. bh0 + REP - 1
// (part_o (.., ns, kD), part_m / part_l (.., ns)); every thread calls it.
template <int REP>
__device__ __forceinline__ void store_chunk(const float (&m)[REP], const float (&l)[REP],
                                            const float4 (&o)[REP], float* part_o,
                                            float* part_m, float* part_l, long long bh0,
                                            int ns, int split) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __shared__ float sm_m[kWarps][REP], sm_l[kWarps][REP];
  __shared__ __align__(16) float sm_o[kWarps][REP][kD];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
    *reinterpret_cast<float4*>(&sm_o[warp][r][4 * lane]) = o[r];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < REP * kD; idx += kThreads) {
    const int r = idx / kD, d = idx % kD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][r]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = (sm_m[w][r] == -INFINITY) ? 0.f : exp2f(sm_m[w][r] - M);
      L += sm_l[w][r] * c;
      O += sm_o[w][r][d] * c;
    }
    const long long bh = bh0 + r;
    part_o[(bh * ns + split) * kD + d] = O;
    if (d == 0) {
      part_m[bh * ns + split] = M;
      part_l[bh * ns + split] = L;
    }
  }
}

// one block a (head, sequence), one thread a feature
__global__ void __launch_bounds__(kD)
    decode_merge_kernel(const float* __restrict__ part_o, const float* __restrict__ part_m,
                        const float* __restrict__ part_l, bf16* __restrict__ out, int H, int ns) {
  const long long bh = (long long)blockIdx.y * H + blockIdx.x;
  const int d = threadIdx.x;
  float M = -INFINITY;
  for (int s = 0; s < ns; ++s) M = fmaxf(M, part_m[bh * ns + s]);
  float L = 0.f, O = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float pm = part_m[bh * ns + s];
    const float c = (pm == -INFINITY) ? 0.f : exp2f(pm - M);
    L += part_l[bh * ns + s] * c;
    O += part_o[(bh * ns + s) * kD + d] * c;
  }
  if (L == 0.f) L = 1.f;
  out[bh * kD + d] = __float2bfloat16_rn(O / L);
}

}  // namespace
