// gather_rows: out[i, :] = table[src[i], :] for every row i below its
// bucket's count (bucket i / C of counts (n / C,)), whose src lies in
// [0, n_table); every other row of out is zero.  Optionally weighted:
// out[i, :] = w[i] * table[src[i], :], the product in fp32 and rounded
// once to the table's dtype.
//
// Replaces no TPU kernel: the JAX package's LL dispatch (repro/core/ep.py
// dispatch_combine_ll) gathers a send buffer, exchanges it by
// all_to_all and transposes it into the expert-major layout, which a
// mesh of chips needs.  The port's rank-stacked world (core/ep.py) writes
// each (token, choice) row once, straight into its expert's receive rows
// (E, P * C, D), as DeepEP's and UCCL-EP's LL dispatch write into the
// receiver's per-expert buffer; this kernel is that write.  Weighted, it
// is the backward of the LL combine (combine_reduce.cu's gathered form):
// each receive row's gradient is its choice's weight times its token's
// upstream row.
//
// Bound on an H100: bytes (each occupied row read once and written once,
// every other row written as zeros, the indices and counts read once).
// At qwen2-moe's decode shape (8,192 receive rows of 2048 bf16, at most
// 2,048 occupied) that is 8.4 MB read and 33.6 MB written: about
// 12.5 us.
//
// Design, as gather_quantize.cu's: a block of 8 warps takes 8 rows, one a
// warp; the first warp reads the 8 rows' indices and counts side by side
// once.  An empty row is zero-stored by its warp without a load.  An
// occupied row is copied as raw bytes in the widest vector (16, 4, 2 or 1
// bytes) that divides the row and both base addresses: every load of a
// lane is issued before its stores, neighbouring lanes on neighbouring
// addresses.  The weighted form converts each element to fp32,
// multiplies (__fmul_rn: one IEEE rounding) and rounds once to the
// table's dtype, one element a lane a step (the backward only).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 8;  // vectors a lane has in flight

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, bf16* out) { *out = __float2bfloat16_rn(v); }

// the table row each of the block's rows reads (-1: an empty row), read by
// the first warp
__device__ __forceinline__ void rows_of_block(const int* __restrict__ src,
                                              const int* __restrict__ cnt, int n_table, int n,
                                              int C, int r0, int* s_row) {
  const int lane = threadIdx.x & 31;
  if ((threadIdx.x >> 5) == 0 && lane < kWarps) {
    int row = -1;
    const int i = r0 + lane;
    if (i < n) {
      const int r = src[i];  // loaded beside the count
      const int c = cnt ? min(max(cnt[i / C], 0), C) : C;
      if (i % C < c && r >= 0 && r < n_table) row = r;
    }
    s_row[lane] = row;
  }
  __syncthreads();
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    row_gather_kernel(const uint8_t* __restrict__ table, const int* __restrict__ src,
                      const int* __restrict__ cnt, uint8_t* __restrict__ out, int n_table, int n,
                      int C, int row_bytes) {
  __shared__ int s_row[kWarps];
  const int r0 = blockIdx.x * kWarps;
  rows_of_block(src, cnt, n_table, n, C, r0, s_row);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = r0 + warp;
  if (i >= n) return;
  const int row = s_row[warp];
  const int nv = row_bytes / (int)sizeof(V);
  V* const o = reinterpret_cast<V*>(out + (size_t)i * row_bytes);
  if (row < 0) {
    const V z{};
    for (int v = lane; v < nv; v += 32) o[v] = z;
    return;
  }
  const V* const t = reinterpret_cast<const V*>(table + (size_t)row * row_bytes);
  for (int v0 = lane; v0 < nv; v0 += 32 * kUnroll) {
    V buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + 32 * u;
      if (v < nv) buf[u] = __ldg(t + v);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + 32 * u;
      if (v < nv) o[v] = buf[u];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    row_gather_weighted_kernel(const T* __restrict__ table, const int* __restrict__ src,
                               const int* __restrict__ cnt, const float* __restrict__ w,
                               T* __restrict__ out, int n_table, int n, int C, int D) {
  __shared__ int s_row[kWarps];
  const int r0 = blockIdx.x * kWarps;
  rows_of_block(src, cnt, n_table, n, C, r0, s_row);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = r0 + warp;
  if (i >= n) return;
  const int row = s_row[warp];
  T* const o = out + (size_t)i * D;
  if (row < 0) {
    for (int d = lane; d < D; d += 32) from_f32(0.0f, &o[d]);
    return;
  }
  const float wi = w[i];
  const T* const t = table + (size_t)row * D;
  for (int d = lane; d < D; d += 32) from_f32(__fmul_rn(wi, to_f32(t[d])), &o[d]);
}

template <typename V>
void launch_copy(const void* table, const void* src, const void* cnt, void* out, int n_table,
                 int n, int C, int row_bytes, cudaStream_t s) {
  row_gather_kernel<V><<<(n + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(table), static_cast<const int*>(src),
      static_cast<const int*>(cnt), static_cast<uint8_t*>(out), n_table, n, C, row_bytes);
}

template <typename T>
void launch_weighted(const void* table, const void* src, const void* cnt, const void* w,
                     void* out, int n_table, int n, int C, int D, cudaStream_t s) {
  row_gather_weighted_kernel<T><<<(n + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      static_cast<const T*>(table), static_cast<const int*>(src), static_cast<const int*>(cnt),
      static_cast<const float*>(w), static_cast<T*>(out), n_table, n, C, D);
}

}  // namespace

// table (n_table, D) and out (n, D) contiguous, of one dtype (bf16: 1,
// fp32: 0); src (n,) int32; cnt (n / C,) int32 or null (every row below
// its count); w (n,) fp32 or null (a copy).  vec_bytes (16, 4, 2 or 1)
// divides the row's bytes and both base addresses (the wrapper picks it).
extern "C" int gather_rows_launch(const void* table, const void* src, const void* cnt,
                                  const void* w, void* out, int n_table, int n, int C, int D,
                                  int is_bf16, int vec_bytes, void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  if (w != nullptr) {
    if (is_bf16)
      launch_weighted<bf16>(table, src, cnt, w, out, n_table, n, C, D, s);
    else
      launch_weighted<float>(table, src, cnt, w, out, n_table, n, C, D, s);
    return static_cast<int>(cudaGetLastError());
  }
  const int row_bytes = D * (is_bf16 ? 2 : 4);
  switch (vec_bytes) {
    case 16: launch_copy<uint4>(table, src, cnt, out, n_table, n, C, row_bytes, s); break;
    case 4: launch_copy<unsigned>(table, src, cnt, out, n_table, n, C, row_bytes, s); break;
    case 2: launch_copy<unsigned short>(table, src, cnt, out, n_table, n, C, row_bytes, s); break;
    case 1: launch_copy<unsigned char>(table, src, cnt, out, n_table, n, C, row_bytes, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
