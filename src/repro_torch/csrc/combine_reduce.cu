// combine_reduce: out[t, :] = sum_k w[t, k] * parts[t, k, :], summed in
// fp32 in k order and rounded once to the output dtype; parts (T, K, D)
// bf16 or fp32, w (T, K) fp32 or bf16, out (T, D) in the parts' dtype.
//
// The gathered form reads each token's K rows where they lie:
// out[t, :] = sum_k w[t, k] * rows[sel[t, k], :], rows (n_rows, D), sel
// (T, K) int32, a slot outside [0, n_rows) (-1: a dropped or invalid
// choice) adding exactly 0; out (T, D) bf16 or fp32.  It is the LL
// combine's gather folded into this kernel (core/ep.py: the rows are the
// expert outputs where the expert kernel left them, (E, P * C, D)); the
// JAX package has no gathered form, its combine gathering a (T, K, D)
// buffer first.
//
// Replaces the TPU kernel repro/kernels/combine_reduce.py:22
// combine_reduce_pallas (body _cr_kernel :15), the package's public
// weighted combine (ops.combine_reduce, repro/kernels/ops.py:152).
//
// Bound on an H100: memory.  At the HT prefill's combine shape (T 1024,
// K 4, D 2048, bf16 parts, fp32 weights) the call reads 16.8 MB of parts
// and writes 4.2 MB: 6.3 us at 3.35 TB/s, against 2 flops an element
// read.  The LL decode's gathered call (T 512, K 4 or 6, D 2048) reads
// the kept choices' rows, 8.4 or 12.6 MB, and writes 2.1 MB.  Design: a
// thread owns 16 bytes of a token's output row (8 bf16 or 4 fp32
// features of the input; scalar loads when D is not a multiple of that),
// reads each of the token's K rows there once with one 16-byte load,
// neighbouring threads on neighbouring addresses, and keeps the sums in
// fp32 registers.  Products and sums round separately (__fmul_rn,
// __fadd_rn: no FMA contraction), so the kernel equals the plain
// version's k-ordered fp32 loop bit for bit.  CUDA rather than Triton
// keeps one build path (nvcc, ctypes) for every kernel.
//
// combine_dot (the gathered form's weight gradient): dw[t, k] =
// <dout[t, :], rows[sel[t, k], :]> in fp32, 0 where the slot is outside
// the rows; a warp a (t, k), a shuffle sum.  The rows' gradient is
// gather_rows.cu's weighted form.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;
constexpr int kDotWarps = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, bf16* out) { *out = __float2bfloat16_rn(v); }

// kGather: row k of token t is rows[sel[t * K + k]] (a slot outside
// [0, n_rows) adds exactly 0), else parts[t * K + k]
template <typename TP, typename TW, typename TO, bool VEC, bool kGather>
__global__ void __launch_bounds__(kThreads)
    combine_reduce_kernel(const TP* __restrict__ parts, const int* __restrict__ sel,
                          const TW* __restrict__ w, TO* __restrict__ out, int K, int D,
                          int n_rows) {
  constexpr int kV = 16 / sizeof(TP);  // features a thread
  const long long t = blockIdx.x;
  const int d0 = (blockIdx.y * kThreads + threadIdx.x) * kV;
  if (d0 >= D) return;
  float acc[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) acc[i] = 0.f;
  for (int k = 0; k < K; ++k) {
    const float wk = to_f32(w[t * K + k]);
    long long r = t * K + k;
    bool live = true;
    if (kGather) {
      const int s = sel[t * K + k];
      live = s >= 0 && s < n_rows;
      r = s;
    }
    __align__(16) TP v[kV];
    if (!live) {
#pragma unroll
      for (int i = 0; i < kV; ++i) v[i] = TP(0.f);
    } else if (VEC) {
      *reinterpret_cast<uint4*>(v) =
          __ldg(reinterpret_cast<const uint4*>(parts + r * D + d0));
    } else {
      const TP* row = parts + r * D + d0;
#pragma unroll
      for (int i = 0; i < kV; ++i) v[i] = (d0 + i < D) ? row[i] : TP(0.f);
    }
    // a dead slot adds +0, as the plain version's where(keep, ..., 0)
#pragma unroll
    for (int i = 0; i < kV; ++i)
      acc[i] = __fadd_rn(acc[i], live ? __fmul_rn(wk, to_f32(v[i])) : 0.0f);
  }
  TO* o = out + t * D + d0;
  if constexpr (VEC && sizeof(TO) == sizeof(TP)) {
    __align__(16) TO res[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) from_f32(acc[i], &res[i]);
    *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(res);
  } else {
#pragma unroll
    for (int i = 0; i < kV; ++i)
      if (d0 + i < D) from_f32(acc[i], &o[i]);
  }
}

template <typename TO, typename TP>
__global__ void __launch_bounds__(32 * kDotWarps)
    combine_dot_kernel(const TO* __restrict__ dout, const TP* __restrict__ rows,
                       const int* __restrict__ sel, float* __restrict__ dw, int TK, int K, int D,
                       int n_rows) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kDotWarps + (threadIdx.x >> 5);  // (t, k) flat
  if (j >= TK) return;
  const int s = sel[j];
  float acc = 0.f;
  if (s >= 0 && s < n_rows) {
    const TO* g = dout + (long long)(j / K) * D;
    const TP* r = rows + (long long)s * D;
    for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(g[d]), to_f32(r[d]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dw[j] = acc;
}

template <typename TP, typename TW, typename TO, bool kGather>
cudaError_t launch(const void* parts, const void* sel, const void* w, void* out, int T, int K,
                   int D, int n_rows, cudaStream_t s) {
  constexpr int kV = 16 / sizeof(TP);
  const dim3 grid(T, (D + kThreads * kV - 1) / (kThreads * kV));
  // rows start 16-byte aligned when D is a multiple of kV (the wrapper
  // checks the base pointers)
  if (D % kV == 0)
    combine_reduce_kernel<TP, TW, TO, true, kGather><<<grid, kThreads, 0, s>>>(
        static_cast<const TP*>(parts), static_cast<const int*>(sel),
        static_cast<const TW*>(w), static_cast<TO*>(out), K, D, n_rows);
  else
    combine_reduce_kernel<TP, TW, TO, false, kGather><<<grid, kThreads, 0, s>>>(
        static_cast<const TP*>(parts), static_cast<const int*>(sel),
        static_cast<const TW*>(w), static_cast<TO*>(out), K, D, n_rows);
  return cudaGetLastError();
}

template <typename TP, typename TO>
cudaError_t launch_gathered(const void* rows, const void* sel, const void* w, void* out, int T,
                            int K, int D, int n_rows, int w_bf16, cudaStream_t s) {
  return w_bf16 ? launch<TP, bf16, TO, true>(rows, sel, w, out, T, K, D, n_rows, s)
                : launch<TP, float, TO, true>(rows, sel, w, out, T, K, D, n_rows, s);
}

template <typename TO, typename TP>
cudaError_t launch_dot(const void* dout, const void* rows, const void* sel, void* dw, int T,
                       int K, int D, int n_rows, cudaStream_t s) {
  const int TK = T * K;
  combine_dot_kernel<TO, TP><<<(TK + kDotWarps - 1) / kDotWarps, 32 * kDotWarps, 0, s>>>(
      static_cast<const TO*>(dout), static_cast<const TP*>(rows), static_cast<const int*>(sel),
      static_cast<float*>(dw), TK, K, D, n_rows);
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
    err = w_bf16 ? launch<bf16, bf16, bf16, false>(parts, nullptr, w, out, T, K, D, 0, s)
                 : launch<bf16, float, bf16, false>(parts, nullptr, w, out, T, K, D, 0, s);
  else
    err = w_bf16 ? launch<float, bf16, float, false>(parts, nullptr, w, out, T, K, D, 0, s)
                 : launch<float, float, float, false>(parts, nullptr, w, out, T, K, D, 0, s);
  return static_cast<int>(err);
}

// the gathered form: rows (n_rows, D), sel (T, K) int32, w (T, K), out
// (T, D), contiguous; rows_bf16 / w_bf16 / out_bf16 select bf16 (1) or
// fp32 (0)
extern "C" int combine_reduce_gathered_launch(const void* rows, const void* sel, const void* w,
                                              void* out, int T, int K, int D, int n_rows,
                                              int rows_bf16, int w_bf16, int out_bf16,
                                              void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rows_bf16)
    err = out_bf16 ? launch_gathered<bf16, bf16>(rows, sel, w, out, T, K, D, n_rows, w_bf16, s)
                   : launch_gathered<bf16, float>(rows, sel, w, out, T, K, D, n_rows, w_bf16, s);
  else
    err = out_bf16 ? launch_gathered<float, bf16>(rows, sel, w, out, T, K, D, n_rows, w_bf16, s)
                   : launch_gathered<float, float>(rows, sel, w, out, T, K, D, n_rows, w_bf16,
                                                   s);
  return static_cast<int>(err);
}

// dw (T, K) fp32 = <dout[t], rows[sel[t, k]]>: dout (T, D), rows (n_rows,
// D), sel (T, K) int32, contiguous; dout_bf16 / rows_bf16 select bf16 (1)
// or fp32 (0)
extern "C" int combine_dot_launch(const void* dout, const void* rows, const void* sel, void* dw,
                                  int T, int K, int D, int n_rows, int dout_bf16, int rows_bf16,
                                  void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dout_bf16)
    err = rows_bf16 ? launch_dot<bf16, bf16>(dout, rows, sel, dw, T, K, D, n_rows, s)
                    : launch_dot<bf16, float>(dout, rows, sel, dw, T, K, D, n_rows, s);
  else
    err = rows_bf16 ? launch_dot<float, bf16>(dout, rows, sel, dw, T, K, D, n_rows, s)
                    : launch_dot<float, float>(dout, rows, sel, dw, T, K, D, n_rows, s);
  return static_cast<int>(err);
}
