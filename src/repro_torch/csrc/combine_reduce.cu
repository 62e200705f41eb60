// combine_reduce: out[t, :] = sum_k w[t, k] * parts[t, k, :], summed in
// fp32 in k order and rounded once to the parts' dtype; parts (T, K, D)
// bf16 or fp32, w (T, K) fp32 or bf16, out (T, D) in the parts' dtype.
//
// Replaces the TPU kernel repro/kernels/combine_reduce.py:22
// combine_reduce_pallas (body _cr_kernel :15), the package's public
// weighted combine (ops.combine_reduce, repro/kernels/ops.py:152).
//
// Bound on an H100: memory.  At the HT prefill's combine shape (T 1024,
// K 4, D 2048, bf16 parts, fp32 weights) the call reads 16.8 MB of parts
// and writes 4.2 MB: 6.3 us at 3.35 TB/s, against 2 flops an element
// read.  Design: a thread owns 16 bytes of a token's output row (8 bf16
// or 4 fp32 features; scalar loads when D is not a multiple of that),
// reads each of the token's K parts rows there once with one 16-byte
// load, neighbouring threads on neighbouring addresses, and keeps the
// sums in fp32 registers.  Products and sums round separately
// (__fmul_rn, __fadd_rn: no FMA contraction), so the kernel equals the
// plain version's k-ordered fp32 loop bit for bit.  CUDA rather than
// Triton keeps one build path (nvcc, ctypes) for every kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, bf16* out) { *out = __float2bfloat16_rn(v); }

template <typename TP, typename TW, bool VEC>
__global__ void __launch_bounds__(kThreads)
    combine_reduce_kernel(const TP* __restrict__ parts, const TW* __restrict__ w,
                          TP* __restrict__ out, int K, int D) {
  constexpr int kV = 16 / sizeof(TP);  // features a thread
  const long long t = blockIdx.x;
  const int d0 = (blockIdx.y * kThreads + threadIdx.x) * kV;
  if (d0 >= D) return;
  float acc[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) acc[i] = 0.f;
  for (int k = 0; k < K; ++k) {
    const float wk = to_f32(w[t * K + k]);
    const TP* row = parts + (t * K + k) * D + d0;
    __align__(16) TP v[kV];
    if (VEC) {
      *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(row));
    } else {
#pragma unroll
      for (int i = 0; i < kV; ++i) v[i] = (d0 + i < D) ? row[i] : TP(0.f);
    }
#pragma unroll
    for (int i = 0; i < kV; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(wk, to_f32(v[i])));
  }
  TP* o = out + t * D + d0;
  if (VEC) {
    __align__(16) TP r[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) from_f32(acc[i], &r[i]);
    *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(r);
  } else {
#pragma unroll
    for (int i = 0; i < kV; ++i)
      if (d0 + i < D) from_f32(acc[i], &o[i]);
  }
}

template <typename TP, typename TW>
cudaError_t launch(const void* parts, const void* w, void* out, int T, int K, int D,
                   cudaStream_t s) {
  constexpr int kV = 16 / sizeof(TP);
  const dim3 grid(T, (D + kThreads * kV - 1) / (kThreads * kV));
  // rows start 16-byte aligned when D is a multiple of kV (the wrapper
  // checks the base pointers)
  if (D % kV == 0)
    combine_reduce_kernel<TP, TW, true><<<grid, kThreads, 0, s>>>(
        static_cast<const TP*>(parts), static_cast<const TW*>(w), static_cast<TP*>(out), K, D);
  else
    combine_reduce_kernel<TP, TW, false><<<grid, kThreads, 0, s>>>(
        static_cast<const TP*>(parts), static_cast<const TW*>(w), static_cast<TP*>(out), K, D);
  return cudaGetLastError();
}

}  // namespace

// parts (T, K, D), w (T, K), out (T, D), contiguous; parts_bf16 / w_bf16
// select bf16 (1) or fp32 (0) for each.
extern "C" int combine_reduce_launch(const void* parts, const void* w, void* out, int T, int K,
                                     int D, int parts_bf16, int w_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (parts_bf16)
    err = w_bf16 ? launch<bf16, bf16>(parts, w, out, T, K, D, s)
                 : launch<bf16, float>(parts, w, out, T, K, D, s);
  else
    err = w_bf16 ? launch<float, bf16>(parts, w, out, T, K, D, s)
                 : launch<float, float>(parts, w, out, T, K, D, s);
  return static_cast<int>(err);
}
