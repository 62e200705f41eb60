// Shared pieces of the two flash-decoding kernels (decode_attention.cu,
// contiguous cache; decode_attention_paged.cu, block pools): the head dim,
// the block size, the base-2 scale and P's rounding to bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kD = 128;
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

}  // namespace
