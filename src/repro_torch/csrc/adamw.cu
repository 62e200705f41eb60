// adamw: one AdamW step over fp32 parameter leaves, clipped by the global
// gradient norm, in two passes over the bytes and with no host sync.
//
// Replaces no TPU kernel: the JAX package leaves its optimizer
// (repro/optim/adamw.py:43-63, apply_updates) to XLA, which fuses a leaf's
// update into one loop.  Added because the port's eager chain, some 15
// elementwise kernels a leaf that each read and write whole fp32 tensors
// (~140 B a parameter), took 39-46% of an EP training step on an H100.
//
// Bound on an H100: memory.  A clipped step has to read the gradient once
// for the norm (4 B a parameter), then read g, p, mu, nu and write p, mu,
// nu once (28 B): 32 B a parameter, 29.1 ms at 3.35 TB/s for the 3.04B
// parameters of qwen2-moe's EP training shape, against ~0.3 flops a byte.
// Design: three kernels on the caller's stream.
//   adamw_norm_partials (one launch a leaf): a leaf's sum of squares, one
//     partial a block, 16-byte float4 loads and a scalar tail; each thread
//     sums in fp64 (free at one operation per 4 bytes read, where an fp32
//     running sum over the ~1,200 elements a thread takes at 311M drifts
//     by ~1e-6), then warp shuffles and a block reduction.  No atomics:
//     a block count fixed by the leaf's size and fixed reduction orders
//     give the same bits on every run and every card.
//   adamw_norm_finish (one launch): one block sums every leaf's partials
//     in a fixed order and writes gnorm and the clip scale
//     min(1, max_norm / (gnorm + 1e-9)) (1 without a clip, NaN through a
//     NaN norm as torch.clamp passes it) to device memory, which the
//     update reads: the scale never visits the host.
//   adamw_update (one launch a leaf): grid-stride over float4s of the four
//     tensors (scalar loads where a base is not 16-byte aligned), a scalar
//     tail, the grid at the card's resident blocks; each thread reads the
//     scale once and runs the reference's order of operations in fp32 with
//     IEEE division and sqrtf (the build has no fast math), writing p, mu
//     and nu in place.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // partials and update blocks
constexpr int kFinishThreads = 1024;

struct Hyper {
  float lr, b1, b2, one_b1, one_b2, c1, c2, eps, wd;
};

// the block's sum of v, in thread 0; a fixed order of shuffles and warps
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    norm_partials_kernel(const float* __restrict__ g, long long n, double* __restrict__ partials) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  double acc = 0.0;
  long long tail = 0;
  if (VEC) {
    const long long n4 = n >> 2;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (long long j = i; j < n4; j += stride) {
      const float4 v = __ldg(g4 + j);
      acc = fma(static_cast<double>(v.x), static_cast<double>(v.x), acc);
      acc = fma(static_cast<double>(v.y), static_cast<double>(v.y), acc);
      acc = fma(static_cast<double>(v.z), static_cast<double>(v.z), acc);
      acc = fma(static_cast<double>(v.w), static_cast<double>(v.w), acc);
    }
    tail = n4 << 2;
  }
  for (long long j = tail + i; j < n; j += stride) {
    const double x = __ldg(g + j);
    acc = fma(x, x, acc);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kFinishThreads)
    norm_finish_kernel(const double* __restrict__ partials, int n, float max_norm, int clip,
                       float* __restrict__ out) {
  double acc = 0.0;
  for (int j = threadIdx.x; j < n; j += kFinishThreads) acc += partials[j];
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    const float gnorm = static_cast<float>(sqrt(acc));
    float scale = 1.f;
    if (clip) {
      const float s = max_norm / (gnorm + 1e-9f);
      scale = s > 1.f ? 1.f : s;  // a NaN stays NaN, as under torch.clamp
    }
    out[0] = gnorm;
    out[1] = scale;
  }
}

// the reference's order of operations (repro/optim/adamw.py:50-62)
__device__ __forceinline__ void adamw_step(float& p, float g, float& m, float& v, float scale,
                                           const Hyper& h) {
  g = g * scale;
  m = h.b1 * m + h.one_b1 * g;
  v = h.b2 * v + h.one_b2 * g * g;
  const float u = (m / h.c1) / (sqrtf(v / h.c2) + h.eps);
  p = p - h.lr * (u + h.wd * p);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    update_kernel(float* __restrict__ p, const float* __restrict__ g, float* __restrict__ m,
                  float* __restrict__ v, long long n, const float* __restrict__ scale_at, Hyper h) {
  const float scale = *scale_at;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long tail = 0;
  if (VEC) {
    const long long n4 = n >> 2;
    float4* p4 = reinterpret_cast<float4*>(p);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (long long j = i; j < n4; j += stride) {
      float4 pp = p4[j], mm = m4[j], vv = v4[j];
      const float4 gg = __ldg(g4 + j);
      adamw_step(pp.x, gg.x, mm.x, vv.x, scale, h);
      adamw_step(pp.y, gg.y, mm.y, vv.y, scale, h);
      adamw_step(pp.z, gg.z, mm.z, vv.z, scale, h);
      adamw_step(pp.w, gg.w, mm.w, vv.w, scale, h);
      p4[j] = pp;
      m4[j] = mm;
      v4[j] = vv;
    }
    tail = n4 << 2;
  }
  for (long long j = tail + i; j < n; j += stride) {
    float pp = p[j], mm = m[j], vv = v[j];
    adamw_step(pp, __ldg(g + j), mm, vv, scale, h);
    p[j] = pp;
    m[j] = mm;
    v[j] = vv;
  }
}

// blocks of update_kernel<VEC> resident on the card at once
template <bool VEC>
int resident_blocks() {
  static const int blocks = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, update_kernel<VEC>, kThreads, 0);
    return (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }();
  return blocks;
}

template <bool VEC>
cudaError_t launch_update(float* p, const float* g, float* m, float* v, long long n,
                          const float* scale, const Hyper& h, cudaStream_t s) {
  const long long items = VEC ? (n + 3) / 4 : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  const int most = resident_blocks<VEC>();
  if (blocks > most) blocks = most;
  update_kernel<VEC><<<static_cast<int>(blocks), kThreads, 0, s>>>(p, g, m, v, n, scale, h);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// g (n,) fp32, contiguous, n > 0; partials: `blocks` fp64, one a block,
// written whole.  The caller picks `blocks` (1..1024) from n alone.
extern "C" int adamw_norm_partials_launch(const void* g, long long n, void* partials, int blocks,
                                          void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  double* out = static_cast<double*>(partials);
  if (aligned16(g))
    norm_partials_kernel<true><<<blocks, kThreads, 0, s>>>(gf, n, out);
  else
    norm_partials_kernel<false><<<blocks, kThreads, 0, s>>>(gf, n, out);
  return static_cast<int>(cudaGetLastError());
}

// out (2,) fp32: the global norm over n partials (n >= 0) and the clip
// scale (clip 0: 1).
extern "C" int adamw_norm_finish_launch(const void* partials, int n, float max_norm, int clip,
                                        void* out, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  norm_finish_kernel<<<1, kFinishThreads, 0, s>>>(static_cast<const double*>(partials), n,
                                                  max_norm, clip, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// p, g, mu, nu (n,) fp32, contiguous, n > 0; scale: one fp32 on the device
// (adamw_norm_finish_launch's out + 1); one_b1 = 1 - b1 and one_b2 = 1 - b2
// rounded on the host, as the reference's weak-typed constants are.
extern "C" int adamw_update_launch(void* p, const void* g, void* mu, void* nu, long long n,
                                   const void* scale, float lr, float b1, float b2, float one_b1,
                                   float one_b2, float c1, float c2, float eps,
                                   float weight_decay, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Hyper h{lr, b1, b2, one_b1, one_b2, c1, c2, eps, weight_decay};
  float* pf = static_cast<float*>(p);
  const float* gf = static_cast<const float*>(g);
  float* mf = static_cast<float*>(mu);
  float* vf = static_cast<float*>(nu);
  const float* sc = static_cast<const float*>(scale);
  cudaError_t err;
  if (aligned16(p) && aligned16(g) && aligned16(mu) && aligned16(nu))
    err = launch_update<true>(pf, gf, mf, vf, n, sc, h, s);
  else
    err = launch_update<false>(pf, gf, mf, vf, n, sc, h, s);
  return static_cast<int>(err);
}
