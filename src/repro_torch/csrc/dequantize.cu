// dequantize: out[r, d] = float(q[r, d]) * scales[r, d / 128], fp32 out.
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
// scales).  Design: the unit of work is kV wire bytes of one row (kV = 4
// where D % 4 == 0, else 1, so that no unit straddles a row; 4 divides the
// 128-feature scale block, so a unit takes one scale), read in one load
// and written as one float4 (one float where kV is 1).  Neighbouring lanes
// take neighbouring units, so a warp's load reads 128 contiguous bytes and
// its store writes 512: every sector it touches it fills.  (A thread of
// 16 wire bytes writes its 64 output bytes as four stores at a 64-byte
// stride across the warp, each half filling its sectors: ~46% of the bound
// on an H100, PERF.md.)  A thread takes kUnits units a block-width apart
// and issues all their loads before their stores.  A unit's row and column
// come from one 32-bit division.
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

template <int kV>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const uint8_t* __restrict__ q, const float* __restrict__ scales,
                  float* __restrict__ out, unsigned per_row, unsigned total, int nb, int f8) {
  using T = typename Wire<kV>::T;
  const unsigned first = blockIdx.x * (kThreads * kUnits) + threadIdx.x;
  T w[kUnits] = {};
  float s[kUnits] = {};
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const unsigned i = first + u * kThreads;
    if (i < total) {
      const unsigned r = i / per_row, c = (i - r * per_row) * kV;
      s[u] = scales[(size_t)r * nb + c / kBlock];
      w[u] = reinterpret_cast<const T*>(q)[i];       // bytes r * D + c ...
    }
  }
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const unsigned i = first + u * kThreads;
    if (i < total) {
      if constexpr (kV == 4)
        reinterpret_cast<float4*>(out)[i] = decode4(w[u], s[u], f8 != 0);
      else
        out[i] = __fmul_rn(decode1(w[u], f8 != 0), s[u]);
    }
  }
}

template <int kV>
int launch(const void* q, const void* scales, void* out, int N, int D, int nb, int f8,
           cudaStream_t stream) {
  constexpr unsigned kPerBlock = kThreads * kUnits;
  const unsigned long long total = (unsigned long long)N * (D / kV);
  if (total > (1ull << 32) - kPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = (unsigned)((total + kPerBlock - 1) / kPerBlock);
  dequantize_kernel<kV><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), (unsigned)(D / kV), (unsigned)total, nb, f8);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, scales and out 16-byte aligned (the wrapper checks); N * D / kV at
// most 2^32 - 1024, else cudaErrorInvalidValue and no launch
extern "C" int dequantize_launch(const void* q, const void* scales, void* out, int N, int D,
                                 int nb, int f8, void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D % 4 == 0) return launch<4>(q, scales, out, N, D, nb, f8, s);
  return launch<1>(q, scales, out, N, D, nb, f8, s);
}
