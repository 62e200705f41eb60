// Backward kernels of the fp8 / int8 dispatch wire: dequantize_bwd and
// gather_quantize_bwd.
//
// The TPU package has no backward kernels: its training differentiates the
// oracles of repro/kernels/quantize_pack.py:161 dequantize_pallas and :105
// gather_quantize_pallas as core/ep.py::_quantized_a2a chains them.  The
// quantized bytes cross the wire bitcast to uint8, which carries no
// gradient, so the tokens' gradient flows only through the fp32 block
// scales, scale = absmax * qinv (qinv the codec's pre-rounded f32 1 / qmax):
//
//   dequantize_bwd:      d_scales[r, b] = sum_{j in block b} dy[r, j] q[r, j]
//                        (q gets no gradient: it is a bit pattern)
//   gather_quantize_bwd: for each occupied slot s and block b, row src[s]
//                        gets (d_scales[s, b] * qinv) / ties * sign(x) at
//                        the block's absmax element(s), ties shared equally
//                        as the max's gradient is; rows past their count and
//                        all-zero blocks get nothing
//
// Bound on an H100: bytes.  dequantize_bwd reads q (1 byte) and dy (4) an
// element and writes a scale a block; gather_quantize_bwd reads the
// occupied slots' table rows and their scales and adds one value a block.
// Design: one warp a (row, block) of 128 features, 4 elements a lane at a
// 32-element stride (a warp reads 128 contiguous dy floats and q bytes at
// a time), sums and maxima by shuffles.  gather_quantize_bwd adds with fp32
// atomics, since one token fills several slots (HT's dedup'd entries, LL's
// K choices); the order of those adds changes run to run.
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;      // features a scale
constexpr int kWarps = 8;        // (row, block) pairs a thread block
constexpr int kPer = kBlock / 32;

__device__ __forceinline__ float decode1(uint8_t b, bool f8) {
  return f8 ? __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)))
            : static_cast<float>(static_cast<int8_t>(b));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(32 * kWarps)
    dequantize_bwd_kernel(const uint8_t* __restrict__ q, const float* __restrict__ dy,
                          float* __restrict__ ds, int N, int D, int nb, int f8) {
  const long long w = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (w >= (long long)N * nb) return;
  const int lane = threadIdx.x % 32;
  const long long r = w / nb;
  const int b = static_cast<int>(w - r * nb);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = b * kBlock + lane + 32 * i;
    if (j < D) acc += dy[r * D + j] * decode1(q[r * D + j], f8 != 0);
  }
  acc = warp_sum(acc);
  if (lane == 0) ds[w] = acc;
}

__global__ void __launch_bounds__(32 * kWarps)
    gather_quantize_bwd_kernel(const float* __restrict__ x, const int* __restrict__ src,
                               const int* __restrict__ cnt, const float* __restrict__ ds,
                               float* __restrict__ dx, int Tp1, int n_slots, int C, int D,
                               int nb, float qinv) {
  const long long w = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (w >= (long long)n_slots * nb) return;
  const int lane = threadIdx.x % 32;
  const int s = static_cast<int>(w / nb), b = static_cast<int>(w - (long long)s * nb);
  if (cnt && s % C >= min(max(cnt[s / C], 0), C)) return;  // past its count
  const float d = ds[w];
  if (d == 0.f) return;  // adds nothing
  const int row = min(max(src[s], 0), Tp1 - 1);  // the row the forward read
  const float* xr = x + (size_t)row * D;
  float v[kPer];
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = b * kBlock + lane + 32 * i;
    v[i] = j < D ? xr[j] : 0.f;
    m = fmaxf(m, fabsf(v[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (m == 0.f) return;  // an all-zero block: sign(0) = 0 everywhere
  float ties = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) ties += fabsf(v[i]) == m ? 1.f : 0.f;
  ties = warp_sum(ties);
  const float g = __fdiv_rn(d * qinv, ties);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = b * kBlock + lane + 32 * i;
    if (j < D && fabsf(v[i]) == m) atomicAdd(dx + (size_t)row * D + j, v[i] > 0.f ? g : -g);
  }
}

unsigned blocks(long long warps) { return static_cast<unsigned>((warps + kWarps - 1) / kWarps); }

}  // namespace

// q (N, D) fp8 e4m3 or int8 bytes, dy (N, D) fp32 -> ds (N, nb) fp32
extern "C" int dequantize_bwd_launch(const void* q, const void* dy, void* ds, int N, int D,
                                     int nb, int f8, void* stream) {
  const long long warps = (long long)N * nb;
  if (warps == 0) return 0;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dequantize_bwd_kernel<<<blocks(warps), 32 * kWarps, 0, st>>>(
      static_cast<const uint8_t*>(q), static_cast<const float*>(dy), static_cast<float*>(ds), N,
      D, nb, f8);
  return static_cast<int>(cudaGetLastError());
}

// x (Tp1, D) fp32, src (n_slots,) int32, cnt (n_slots / C,) int32 or null
// (every slot occupied), ds (n_slots, nb) fp32 -> dx (Tp1, D) fp32, zeroed
// by the caller and added into
extern "C" int gather_quantize_bwd_launch(const void* x, const void* src, const void* cnt,
                                          const void* ds, void* dx, int Tp1, int n_slots, int C,
                                          int D, int nb, float qinv, void* stream) {
  const long long warps = (long long)n_slots * nb;
  if (warps == 0 || Tp1 == 0) return 0;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  gather_quantize_bwd_kernel<<<blocks(warps), 32 * kWarps, 0, st>>>(
      static_cast<const float*>(x), static_cast<const int*>(src), static_cast<const int*>(cnt),
      static_cast<const float*>(ds), static_cast<float*>(dx), Tp1, n_slots, C, D, nb, qinv);
  return static_cast<int>(cudaGetLastError());
}
