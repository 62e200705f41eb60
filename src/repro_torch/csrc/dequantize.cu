// dequantize: out[r, d] = float(q[r, d]) * scales[r, d / 128], fp32 out.
//
// Replaces the TPU kernel repro/kernels/quantize_pack.py:161
// dequantize_pallas (body _dq_kernel :153), the receive half of the fp8 /
// int8 dispatch wire (ep.py:162).
//
// fp8 e4m3 decodes exactly through __nv_cvt_fp8_to_halfraw (every e4m3
// value is a half), and the scale multiply is one IEEE f32 multiply, so the
// result is bit-identical to the plain version.  Bound on an H100: bytes
// (1 byte read and 4 written per element, plus the scales).  Design: a
// grid-stride loop, one element per thread per step, coalesced.
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;

__global__ void dequantize_kernel(const uint8_t* __restrict__ q, const float* __restrict__ scales,
                                  float* __restrict__ out, int N, int D, int nb, int f8) {
  const size_t total = (size_t)N * D;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t r = i / D;
    const int d = (int)(i - r * D);
    const uint8_t b = q[i];
    float v;
    if (f8) {
      v = __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
    } else {
      v = (float)(int8_t)b;
    }
    out[i] = __fmul_rn(v, scales[r * nb + d / kBlock]);
  }
}

}  // namespace

extern "C" int dequantize_launch(const void* q, const void* scales, void* out, int N, int D,
                                 int nb, int f8, void* stream) {
  const size_t total = (size_t)N * D;
  const int threads = 256;
  size_t blocks = (total + threads - 1) / threads;
  if (blocks > 65535u * 8u) blocks = 65535u * 8u;
  dequantize_kernel<<<(unsigned)blocks, threads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), N, D, nb, f8);
  return static_cast<int>(cudaGetLastError());
}
