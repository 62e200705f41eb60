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
// element and writes a scale a block; gather_quantize_bwd reads the table
// rows the occupied slots name, each once, and their scale gradients, and
// writes the whole table's gradient once.
//
// dequantize_bwd: one warp a (row, block) of 128 features, 4 elements a
// lane at a 32-element stride (a warp reads 128 contiguous dy floats and q
// bytes at a time), the sum by shuffles.
//
// gather_quantize_bwd, in two passes, so that a table row is read once
// however many slots name it (LL's K choices, HT's dedup'd entries):
//   1. fold: a thread a (slot, block) adds d_scales[s, b] * qinv into a
//      small (T+1, nb) fp32 buffer at (src[s], b), zeroed first by a
//      memset on the stream (at the training shape 4,097 x 16, 262 KB,
//      which stays in L2).  The product is
//      rounded per slot as the plain version rounds it; the division by the
//      ties waits for pass 2, which is exact for 1, 2 or 4 ties.
//   2. rows: a warp a table row.  It reads the row's folded values first;
//      a block whose value is 0 (no slot names the row, or its slots add
//      nothing) is stored as zeros and never loaded.  Otherwise 16-byte
//      loads (4 features a lane, a warp the block's 128), the absmax and
//      the tie count by redux.sync over the abs values' bits (a NaN wins
//      the max and then ties nothing, as in the plain version), and the
//      block's gradient written whole: the tie values, zeros elsewhere.
//      The table's gradient needs no memset.  A lane keeps kGroup blocks'
//      loads in flight before it reduces.  Where D % 4 != 0 the lanes take
//      4 elements at a 32-element stride with single loads.
// The fold's adds are fp32 atomics, in an order that changes run to run.
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

constexpr int kFoldThreads = 256;  // (slot, block) pairs a block of pass 1
constexpr int kRowWarps = 8;       // table rows a block of pass 2
constexpr int kGroup = 8;          // scale blocks a lane loads before reducing

__global__ void __launch_bounds__(kFoldThreads)
    fold_scales_kernel(const int* __restrict__ src, const int* __restrict__ cnt,
                       const float* __restrict__ ds, float* __restrict__ fold, int Tp1,
                       int n_slots, int C, int nb, float qinv) {
  const long long i = (long long)blockIdx.x * kFoldThreads + threadIdx.x;
  if (i >= (long long)n_slots * nb) return;
  const int s = static_cast<int>(i / nb), b = static_cast<int>(i - (long long)s * nb);
  if (cnt && s % C >= min(max(cnt[s / C], 0), C)) return;  // past its count
  const float d = ds[i];
  if (d == 0.f) return;  // adds nothing
  const int row = min(max(src[s], 0), Tp1 - 1);  // the row the forward read
  atomicAdd(fold + (size_t)row * nb + b, d * qinv);
}

// Lane `lane`'s 4 features of scale block b: 4 consecutive ones (kVec) or 4
// at a 32-feature stride.
template <bool kVec>
__device__ __forceinline__ int feature(int b, int lane, int i) {
  return b * kBlock + (kVec ? 4 * lane + i : lane + 32 * i);
}

template <bool kVec>
__device__ __forceinline__ void load4(const float* __restrict__ xr, int b, int lane, int D,
                                      float (&v)[kPer]) {
  if (kVec) {
    const int j = feature<true>(b, lane, 0);
    const float4 t = j < D ? *reinterpret_cast<const float4*>(xr + j)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = feature<false>(b, lane, i);
      v[i] = j < D ? xr[j] : 0.f;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(float* __restrict__ dr, int b, int lane, int D,
                                       const float (&o)[kPer]) {
  if (kVec) {
    const int j = feature<true>(b, lane, 0);
    if (j < D) *reinterpret_cast<float4*>(dr + j) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = feature<false>(b, lane, i);
      if (j < D) dr[j] = o[i];
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(32 * kRowWarps)
    table_grad_kernel(const float* __restrict__ x, const float* __restrict__ fold,
                      float* __restrict__ dx, int Tp1, int D, int nb) {
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (row >= Tp1) return;
  const int lane = threadIdx.x % 32;
  const float* xr = x + (size_t)row * D;
  const float* fr = fold + (size_t)row * nb;
  float* dr = dx + (size_t)row * D;
  const float zero[kPer] = {0.f, 0.f, 0.f, 0.f};
  for (int b32 = 0; b32 < nb; b32 += 32) {
    // the folded values of 32 blocks, one a lane; which of them are nonzero
    const float fl = b32 + lane < nb ? fr[b32 + lane] : 0.f;
    const unsigned live = __ballot_sync(0xffffffffu, fl != 0.f);
    const int n32 = min(32, nb - b32);
    if (live == 0u) {  // no slot adds to these blocks: zeros, no load
      for (int k = 0; k < n32; ++k) store4<kVec>(dr, b32 + k, lane, D, zero);
      continue;
    }
    for (int k0 = 0; k0 < n32; k0 += kGroup) {
      float v[kGroup][kPer];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int k = k0 + g;
        if (k < n32 && (live >> k & 1u)) {
          load4<kVec>(xr, b32 + k, lane, D, v[g]);
        } else {
#pragma unroll
          for (int i = 0; i < kPer; ++i) v[g][i] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int k = k0 + g;
        if (k >= n32) break;
        const float f = __shfl_sync(0xffffffffu, fl, k);
        unsigned mb = 0u;  // |v| bits: their order is the values' order
#pragma unroll
        for (int i = 0; i < kPer; ++i) mb = max(mb, __float_as_uint(fabsf(v[g][i])));
        mb = __reduce_max_sync(0xffffffffu, mb);
        const float m = __uint_as_float(mb);
        int t = 0;
#pragma unroll
        for (int i = 0; i < kPer; ++i) t += fabsf(v[g][i]) == m ? 1 : 0;
        const float ties = static_cast<float>(__reduce_add_sync(0xffffffffu, t));
        // a block left unloaded or all zero (m == 0): sign(0) = 0 everywhere
        const float gv = m > 0.f ? __fdiv_rn(f, ties) : 0.f;
        float o[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const bool at = m > 0.f && fabsf(v[g][i]) == m;
          o[i] = at ? (v[g][i] > 0.f ? gv : -gv) : 0.f;
        }
        store4<kVec>(dr, b32 + k, lane, D, o);
      }
    }
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
// (every slot occupied), ds (n_slots, nb) fp32, fold (Tp1, nb) fp32 scratch
// -> dx (Tp1, D) fp32, every element written
extern "C" int gather_quantize_bwd_launch(const void* x, const void* src, const void* cnt,
                                          const void* ds, void* fold, void* dx, int Tp1,
                                          int n_slots, int C, int D, int nb, float qinv,
                                          void* stream) {
  if (Tp1 == 0 || D == 0) return 0;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(fold, 0, sizeof(float) * (size_t)Tp1 * nb, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long pairs = (long long)n_slots * nb;
  if (pairs > 0) {
    fold_scales_kernel<<<static_cast<unsigned>((pairs + kFoldThreads - 1) / kFoldThreads),
                         kFoldThreads, 0, st>>>(
        static_cast<const int*>(src), static_cast<const int*>(cnt),
        static_cast<const float*>(ds), static_cast<float*>(fold), Tp1, n_slots, C, nb, qinv);
  }
  const unsigned grid = static_cast<unsigned>((Tp1 + kRowWarps - 1) / kRowWarps);
  const float* xf = static_cast<const float*>(x);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  if (vec) {
    table_grad_kernel<true><<<grid, 32 * kRowWarps, 0, st>>>(
        xf, static_cast<const float*>(fold), static_cast<float*>(dx), Tp1, D, nb);
  } else {
    table_grad_kernel<false><<<grid, 32 * kRowWarps, 0, st>>>(
        xf, static_cast<const float*>(fold), static_cast<float*>(dx), Tp1, D, nb);
  }
  return static_cast<int>(cudaGetLastError());
}
