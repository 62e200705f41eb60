// rmsnorm: out = bf16(x32 * rsqrt(mean(x32^2) + eps) * scale) per row of
// a (rows, D) bf16 tensor, with an fp32 scale (D,); the sum of squares is
// taken in fp32 and the result rounds once, in the order of the reference
// (rmsnorm.py:12-15, layers.rmsnorm).
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py:19 rmsnorm_pallas
// (body _rms_kernel :10): ln1, ln2 and final_ln at D = d_model, and the
// per-head q_norm / k_norm at D = head_dim on the serving path.
//
// Bound on an H100: a row reduction and an elementwise pass, so reading x
// once and writing out once (4 bytes an element) over 3.35 TB/s; tensor
// cores have nothing to do.  Design: one warp per row for D <= 1024 (the
// 128-wide q/k rows: 8 rows a 256-thread block), one block per row above
// that (d_model rows, partial sums through shared memory).  Each thread
// moves 4 elements (8 bytes) at a time; the second pass re-reads the row,
// which the first pass has just brought into L1/L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWarpRow = 1024;  // widest row one warp takes

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(bf16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool kWarpPerRow>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                   bf16* __restrict__ out, long rows, int D, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long row = kWarpPerRow ? (long)blockIdx.x * kWarps + warp : (long)blockIdx.x;
  const int t0 = kWarpPerRow ? lane : threadIdx.x;
  const int nt = kWarpPerRow ? 32 : kThreads;
  if (row >= rows) return;  // warp mode only: a block-mode grid has one block a row
  const bf16* xr = x + row * D;
  bf16* orow = out + row * D;

  float ss = 0.f;
  for (int c = 4 * t0; c < D; c += 4 * nt) {
    const float4 v = load4(xr + c);
    ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
  ss = warp_sum(ss);
  if (!kWarpPerRow) {
    __shared__ float part[kWarps];
    if (lane == 0) part[warp] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) ss += part[w];
  }
  const float r = rsqrtf(ss / (float)D + eps);
  for (int c = 4 * t0; c < D; c += 4 * nt) {
    const float4 v = load4(xr + c);
    const float4 s = *reinterpret_cast<const float4*>(scale + c);
    store4(orow + c, v.x * r * s.x, v.y * r * s.y, v.z * r * s.z, v.w * r * s.w);
  }
}

}  // namespace

// x, out: (rows, D) bf16, rows contiguous; scale: (D,) fp32; D % 4 == 0
// and every pointer 16-byte aligned (the wrapper checks both).
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out, long long rows,
                              int D, float eps, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* sp = static_cast<const float*>(scale);
  bf16* op = static_cast<bf16*>(out);
  if (D <= kMaxWarpRow) {
    const long blocks = (rows + kWarps - 1) / kWarps;
    rmsnorm_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(xp, sp, op, rows, D, eps);
  } else {
    rmsnorm_kernel<false><<<(unsigned)rows, kThreads, 0, s>>>(xp, sp, op, rows, D, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
