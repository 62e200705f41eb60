// dequantize: out[r, d] = float(q[r, d]) * scales[r, d / 128], fp32 out.
// With counts (the LL receive buffer, rows in buckets of C, bucket b's
// rows at or past cnt[b] empty), an empty row reads nothing and is
// written as zeros; the output may be bf16, the fp32 product rounded once
// (__float2bfloat16_rn, as torch casts the fp32 output to bf16 on the
// card), so the LL decode's expert rows come straight out of
// the wire in the layout the expert kernel reads (core/ep.py).
//
// Replaces the TPU kernel repro/kernels/quantize_pack.py:161
// dequantize_pallas (body _dq_kernel :153), the receive half of the fp8 /
// int8 dispatch wire (ep.py:162).
//
// fp8 e4m3 decodes exactly through half (every e4m3 value is a half; the
// pairwise cvt.rn.f16x2.e4m3x2 is exact too), int8 converts exactly, and
// the scale multiply is one IEEE f32 multiply, so the result is
// bit-identical to the plain version, NaN encodings included (a multiply
// on the card returns its canonical NaN on both sides).
//
// Bound on an H100: bytes (1 byte read and 4 written per element, plus the
// scales; with counts, 1 read and 2 or 4 written per element of an
// occupied row, 2 or 4 written per element of an empty one).  Design: the
// unit of work is kV wire bytes of one row (kV = 4 where D % 4 == 0, else
// 1, so that no unit straddles a row; 4 divides the 128-feature scale
// block, so a unit takes one scale), read in one load and written as one
// float4, or 4 bf16 in one 8-byte store (one value where kV is 1); an
// empty row's unit takes its zeros without a load.  Neighbouring lanes
// take neighbouring units, so a warp's load reads 128 contiguous bytes and
// its store writes 512: every sector it touches it fills.  (A thread of
// 16 wire bytes writes its 64 output bytes as four stores at a 64-byte
// stride across the warp, each half filling its sectors: ~46% of the bound
// on an H100, PERF.md.)  A thread takes kUnits units a block-width apart
// and issues all their loads before their stores.  A unit's row and column
// come from one 32-bit division.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kThreads = 256;
constexpr int kUnits = 4;    // units a thread

template <int kV> struct Wire;
template <> struct Wire<4> { using T = unsigned; };
template <> struct Wire<1> { using T = uint8_t; };

__device__ __forceinline__ float decode1(uint8_t b, bool f8) {
  return f8 ? __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)))
            : static_cast<float>(static_cast<int8_t>(b));
}

// 4 wire bytes (the first in the low byte) times s
__device__ __forceinline__ float4 decode4(unsigned w, float s, bool f8) {
  float v[4];
  if (f8) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w >> (16 * p)), __NV_E4M3);
      const float2 f = __half22float2(__half2(h));
      v[2 * p] = f.x, v[2 * p + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = static_cast<float>(static_cast<int8_t>(w >> (8 * k)));
  }
  return make_float4(__fmul_rn(v[0], s), __fmul_rn(v[1], s), __fmul_rn(v[2], s),
                     __fmul_rn(v[3], s));
}

// 4 values of one unit stored at out + 4 i
__device__ __forceinline__ void store4(float* out, unsigned i, float4 v) {
  reinterpret_cast<float4*>(out)[i] = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* out, unsigned i, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  reinterpret_cast<uint2*>(out)[i] = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                                *reinterpret_cast<const unsigned*>(&hi));
}
__device__ __forceinline__ void store1(float* out, unsigned i, float v) { out[i] = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, unsigned i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

// cnt null: every row occupied; else row r lies in bucket r / C, occupied
// below cnt[r / C], and an empty row's unit decodes zero bytes at scale 0
// (+0) without a load
template <int kV, typename TO>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const uint8_t* __restrict__ q, const float* __restrict__ scales,
                  const int* __restrict__ cnt, TO* __restrict__ out, unsigned per_row,
                  unsigned total, int nb, int C, int f8) {
  using T = typename Wire<kV>::T;
  const unsigned first = blockIdx.x * (kThreads * kUnits) + threadIdx.x;
  T w[kUnits] = {};
  float s[kUnits] = {};
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const unsigned i = first + u * kThreads;
    if (i < total) {
      const unsigned r = i / per_row, c = (i - r * per_row) * kV;
      if (cnt != nullptr && (int)(r % C) >= min(max(cnt[r / C], 0), C)) continue;
      s[u] = scales[(size_t)r * nb + c / kBlock];
      w[u] = reinterpret_cast<const T*>(q)[i];       // bytes r * D + c ...
    }
  }
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const unsigned i = first + u * kThreads;
    if (i < total) {
      if constexpr (kV == 4)
        store4(out, i, decode4(w[u], s[u], f8 != 0));
      else
        store1(out, i, __fmul_rn(decode1(w[u], f8 != 0), s[u]));
    }
  }
}

template <int kV, typename TO>
int launch(const void* q, const void* scales, const void* cnt, void* out, int N, int D, int nb,
           int C, int f8, cudaStream_t stream) {
  constexpr unsigned kPerBlock = kThreads * kUnits;
  const unsigned long long total = (unsigned long long)N * (D / kV);
  if (total > (1ull << 32) - kPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = (unsigned)((total + kPerBlock - 1) / kPerBlock);
  dequantize_kernel<kV, TO><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(q), static_cast<const float*>(scales),
      static_cast<const int*>(cnt), static_cast<TO*>(out), (unsigned)(D / kV), (unsigned)total,
      nb, C, f8);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO>
int launch_rows(const void* q, const void* scales, const void* cnt, void* out, int N, int D,
                int nb, int C, int f8, cudaStream_t s) {
  if (D % 4 == 0) return launch<4, TO>(q, scales, cnt, out, N, D, nb, C, f8, s);
  return launch<1, TO>(q, scales, cnt, out, N, D, nb, C, f8, s);
}

}  // namespace

// q, scales and out 16-byte aligned (the wrapper checks); N * D / kV at
// most 2^32 - 1024, else cudaErrorInvalidValue and no launch
extern "C" int dequantize_launch(const void* q, const void* scales, void* out, int N, int D,
                                 int nb, int f8, void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return launch_rows<float>(q, scales, nullptr, out, N, D, nb, N, f8, s);
}

// as dequantize_launch, with the occupied counts cnt (N / C,) int32 (null:
// every row) and out in bf16 (out_bf16 1) or fp32 (0)
extern "C" int dequantize_rows_launch(const void* q, const void* scales, const void* cnt,
                                      void* out, int N, int D, int nb, int C, int f8,
                                      int out_bf16, void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_rows<__nv_bfloat16>(q, scales, cnt, out, N, D, nb, C, f8, s);
  return launch_rows<float>(q, scales, cnt, out, N, D, nb, C, f8, s);
}
