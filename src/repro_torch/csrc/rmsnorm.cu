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
// cores have nothing to do.  Design: a row is read from memory once and
// held in registers, in 16-byte vectors of 8 values where D % 8 == 0 (8
// bytes of 4 otherwise), until its output is written.  The wrapper picks
// the kernel, through its C entry, and the threads a row gets
// (kernels/norm_attention.py::rmsnorm_threads_per_row); this file refuses
// only what a kernel cannot take.
//   - narrow rows (the q/k norms' 128): rmsnorm_rows_kernel,
//     4 to 32 lanes a row (a power of two).  256-thread blocks hold 256 / T
//     rows at a time and stride over the rows, at most as many blocks as
//     the card keeps resident; the sum of squares reduces by shuffles
//     inside the row's T lanes, with no barrier.  Each block stages scale
//     in shared memory once (cp.async, overlapping its first rows' loads)
//     and reads it from there for every row it normalises.
//   - wider rows: rmsnorm_row_kernel, one row a block of a multiple of 32
//     threads up to 512, 2 vectors a thread (1 where there are fewer rows
//     than SMs, as in the decode step's 4 x 2560), partial sums across the
//     block's warps in shared memory.  At d_model rows this keeps more
//     loads in flight than a warp a row, whose many vectors a lane at D
//     2560 leave room for few warps an SM (PERF.md).  A thread keeps up to
//     4 vectors and their scale in registers; a row wider still
//     (D > 16,384) reads the rest twice.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kRowsThreads = 256;   // block of rmsnorm_rows_kernel
constexpr int kRowMaxThreads = 512; // largest block of rmsnorm_row_kernel
constexpr int kRowsMaxItems = 8;    // vectors a rows-kernel thread holds
// lanes a row in rmsnorm_rows_kernel (a power of two between the two), so
// that a row of kRowsMinLanes * kRowsMaxItems vectors fits at every lane
// count: the widest row the wrapper sends it
// (norm_attention.RMSNORM_ROWS_MAX_VECTORS)
constexpr int kRowsMinLanes = 4;
constexpr int kRowsMaxLanes = 32;
constexpr int kRowMaxItems = 4;     // vectors a row-kernel thread holds

// V bf16 values moved as one load: 16 bytes for V = 8, 8 bytes for V = 4
template <int V> struct Pack;
template <> struct Pack<8> { using T = uint4; };
template <> struct Pack<4> { using T = uint2; };

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void unpack(const uint4& p, float (&f)[8]) {
  const uint32_t w[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = unpack2(w[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void unpack(const uint2& p, float (&f)[4]) {
  const float2 a = unpack2(p.x), b = unpack2(p.y);
  f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

__device__ __forceinline__ uint2 pack(const float (&f)[4]) {
  return make_uint2(pack2(f[0], f[1]), pack2(f[2], f[3]));
}

template <int V>
__device__ __forceinline__ float sum_sq(const typename Pack<V>::T& p) {
  float f[V];
  unpack(p, f);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < V; ++e) s = fmaf(f[e], f[e], s);
  return s;
}

// out vector = x * r * s, for the V scale values s (V / 4 float4s)
template <int V>
__device__ __forceinline__ typename Pack<V>::T normed(const typename Pack<V>::T& p, float r,
                                                      const float4 (&s)[V / 4]) {
  float f[V];
  unpack(p, f);
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    f[4 * q] = f[4 * q] * r * s[q].x;
    f[4 * q + 1] = f[4 * q + 1] * r * s[q].y;
    f[4 * q + 2] = f[4 * q + 2] * r * s[q].z;
    f[4 * q + 3] = f[4 * q + 3] * r * s[q].w;
  }
  return pack(f);
}

// the V scale values from column c on, global memory
template <int V>
__device__ __forceinline__ void scale_at(const float* scale, int c, float4 (&s)[V / 4]) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q) s[q] = *reinterpret_cast<const float4*>(scale + c + 4 * q);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// T lanes a row (a power of two, 4..32); kItems >= ceil(D / (V * T)).
template <int V, int kItems>
__global__ void __launch_bounds__(kRowsThreads)
    rmsnorm_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                        bf16* __restrict__ out, long long rows, int D, float eps, int T) {
  using P = typename Pack<V>::T;
  // scale in shared memory, float4 q of vector j at s_scale[q * nv + j]
  // (nv = D / V vectors), so that lanes reading the same q of
  // consecutive vectors read consecutive 16 bytes
  extern __shared__ float4 s_scale[];
  const int nv = D / V;
  const int lane = threadIdx.x & (T - 1);
  const int slots = kRowsThreads / T;
  const long long step = (long long)gridDim.x * slots;
  for (int i = threadIdx.x; i < D / 4; i += kRowsThreads)
    cp_async16(s_scale + (i % (V / 4)) * nv + i / (V / 4), scale + 4 * i);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  bool staged = false;
  // every thread of the block takes the same number of turns, so the
  // shuffles below always run in full warps
  for (long long r0 = (long long)blockIdx.x * slots; r0 < rows; r0 += step) {
    const long long row = r0 + threadIdx.x / T;
    const bool live = row < rows;
    const bf16* xr = x + (live ? row : 0) * (long long)D;
    P v[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int c = (i * T + lane) * V;
      if (live && c < D) v[i] = *reinterpret_cast<const P*>(xr + c);
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if (live && (i * T + lane) * V < D) ss += sum_sq<V>(v[i]);
    for (int o = T / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float r = rsqrtf(ss / (float)D + eps);
    if (!staged) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      staged = true;
    }
    bf16* orow = out + row * (long long)D;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = i * T + lane, c = j * V;
      if (live && c < D) {
        float4 sc[V / 4];
#pragma unroll
        for (int q = 0; q < V / 4; ++q) sc[q] = s_scale[q * nv + j];
        *reinterpret_cast<P*>(orow + c) = normed<V>(v[i], r, sc);
      }
    }
  }
}

// One row a block of blockDim.x threads (a multiple of 32); the first
// kItems * blockDim.x vectors stay in registers, the rest are read twice.
template <int V, int kItems>
__global__ void __launch_bounds__(kRowMaxThreads)
    rmsnorm_row_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                       bf16* __restrict__ out, int D, float eps) {
  using P = typename Pack<V>::T;
  __shared__ float part[kRowMaxThreads / 32];
  const int T = blockDim.x, tid = threadIdx.x;
  const long long row = blockIdx.x;
  const bf16* xr = x + row * D;
  bf16* orow = out + row * D;
  P v[kItems];
  float4 s[kItems][V / 4];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int c = (i * T + tid) * V;
    if (c < D) {
      v[i] = *reinterpret_cast<const P*>(xr + c);
      scale_at<V>(scale, c, s[i]);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    if ((i * T + tid) * V < D) ss += sum_sq<V>(v[i]);
  for (int c = (kItems * T + tid) * V; c < D; c += T * V)
    ss += sum_sq<V>(*reinterpret_cast<const P*>(xr + c));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((tid & 31) == 0) part[tid >> 5] = ss;
  __syncthreads();
  ss = 0.f;
  for (int w = 0; w < T / 32; ++w) ss += part[w];
  const float r = rsqrtf(ss / (float)D + eps);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int c = (i * T + tid) * V;
    if (c < D) *reinterpret_cast<P*>(orow + c) = normed<V>(v[i], r, s[i]);
  }
  for (int c = (kItems * T + tid) * V; c < D; c += T * V) {
    float4 sc[V / 4];
    scale_at<V>(scale, c, sc);
    *reinterpret_cast<P*>(orow + c) = normed<V>(*reinterpret_cast<const P*>(xr + c), r, sc);
  }
}

// rmsnorm_rows_kernel blocks an SM keeps resident, per instantiation, at
// the largest scale it stages (kItems vectors of each of 32 lanes)
template <int V, int kItems>
int rows_blocks_per_sm() {
  static int n = 0;
  if (n <= 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &n, rmsnorm_rows_kernel<V, kItems>, kRowsThreads,
                    kItems * 32 * V * (int)sizeof(float)) != cudaSuccess)
    n = 0;
  return n > 0 ? n : 1;
}

template <int V, int kItems>
void launch_rows(const bf16* x, const float* scale, bf16* out, long long rows, int D, float eps,
                 int T, int sms, cudaStream_t s) {
  const int smem = D * (int)sizeof(float);
  const long long groups = (rows + kRowsThreads / T - 1) / (kRowsThreads / T);
  const long long resident = (long long)sms * rows_blocks_per_sm<V, kItems>();
  const unsigned grid = (unsigned)(groups < resident ? groups : resident);
  rmsnorm_rows_kernel<V, kItems><<<grid, kRowsThreads, smem, s>>>(x, scale, out, rows, D, eps, T);
}

template <int V>
int rows_launch(const bf16* x, const float* scale, bf16* out, long long rows, int D, float eps,
                int T, int sms, cudaStream_t s) {
  const int items = (D / V + T - 1) / T;
  if (T < kRowsMinLanes || T > kRowsMaxLanes || (T & (T - 1)) || items > kRowsMaxItems)
    return cudaErrorInvalidValue;
  if (items <= 1) launch_rows<V, 1>(x, scale, out, rows, D, eps, T, sms, s);
  else if (items <= 2) launch_rows<V, 2>(x, scale, out, rows, D, eps, T, sms, s);
  else if (items <= 4) launch_rows<V, 4>(x, scale, out, rows, D, eps, T, sms, s);
  else launch_rows<V, kRowsMaxItems>(x, scale, out, rows, D, eps, T, sms, s);
  return cudaSuccess;
}

template <int V>
int row_launch(const bf16* x, const float* scale, bf16* out, long long rows, int D, float eps,
               int T, cudaStream_t s) {
  if (T <= 0 || T % 32 || T > kRowMaxThreads || rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int items = (D / V + T - 1) / T;
  const unsigned grid = (unsigned)rows;
  if (items <= 1) rmsnorm_row_kernel<V, 1><<<grid, T, 0, s>>>(x, scale, out, D, eps);
  else if (items <= 2) rmsnorm_row_kernel<V, 2><<<grid, T, 0, s>>>(x, scale, out, D, eps);
  else rmsnorm_row_kernel<V, kRowMaxItems><<<grid, T, 0, s>>>(x, scale, out, D, eps);
  return cudaSuccess;
}

}  // namespace

// Both entries: x, out (rows, D) bf16, rows contiguous; scale (D,) fp32;
// D % 4 == 0 and every pointer 16-byte aligned (the wrapper checks both).
// A row is cut in vectors of 8 values where D % 8 == 0, else 4.

// rmsnorm_rows_kernel at `lanes` a row (4..32, a power of two), at most
// kRowsMaxItems vectors a lane; sms: the card's SM count (the grid is at
// most one wave of resident blocks).
extern "C" int rmsnorm_rows_launch(const void* x, const void* scale, void* out, long long rows,
                                   int D, float eps, int lanes, int sms, void* stream) {
  if (D <= 0 || D % 4 || rows <= 0 || sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* sp = static_cast<const float*>(scale);
  bf16* op = static_cast<bf16*>(out);
  const int err = D % 8 == 0 ? rows_launch<8>(xp, sp, op, rows, D, eps, lanes, sms, s)
                             : rows_launch<4>(xp, sp, op, rows, D, eps, lanes, sms, s);
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}

// rmsnorm_row_kernel: one row a block of `threads`, a multiple of 32 up to
// kRowMaxThreads.
extern "C" int rmsnorm_row_launch(const void* x, const void* scale, void* out, long long rows,
                                  int D, float eps, int threads, void* stream) {
  if (D <= 0 || D % 4 || rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* sp = static_cast<const float*>(scale);
  bf16* op = static_cast<bf16*>(out);
  const int err = D % 8 == 0 ? row_launch<8>(xp, sp, op, rows, D, eps, threads, s)
                             : row_launch<4>(xp, sp, op, rows, D, eps, threads, s);
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}
