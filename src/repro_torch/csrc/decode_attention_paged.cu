// decode_attention_paged: flash decoding of one query per sequence
// through a paged KV cache.  q (B, H, D) bf16; k / v pools (NB, bs, Hkv, D)
// bf16, D = 128; tables (B, nb) int32 pool block ids (-1, or any id
// outside [0, NB), unallocated); pos (B,) int32 on the device.  Sequence b
// attends the positions p <= pos[b] whose block tables[b, p / bs] is
// allocated, at row p % bs of that block; q head h reads kv head
// h / (H / Hkv).  out (B, H, D) bf16, normalised, 0 where nothing is live.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:149
// decode_attention_paged (body _dec_paged_kernel :101), the package's
// paged decoding entry point (ops.decode_attention_paged here), whose
// tables repro_torch.serving.kv_cache.KVBlockPool makes.  Like that
// kernel (:119) and unlike its oracle (:213, which reads -1 as block 0),
// unallocated blocks are skipped.
//
// Bound on an H100: each live K and V row is read once, 256 bytes a row
// each at D = 128: at qwen3-4b's decode shape (B 4, 8 kv heads, ragged
// pos 2078 / 2047 / 1031 / 17) 21.2 MB, 6.3 us at 3.35 TB/s, so latency
// counts as much as bandwidth.  Design: 8-byte loads a lane, 256-position
// chunks and a second launch to merge them (decode_attention.cu has since
// moved to 16-byte loads and one launch).  pos lives on the device, so
// the host cannot launch only the live chunks: one block per (chunk of
// table columns, kv head, sequence) always launches, reads pos[b] and its
// table entries into shared memory, and returns at once when nothing of
// its chunk is live; a warp takes kKB positions at a time, loads only
// those that are live (an allocated block, p <= pos[b]) and scores the
// rest -inf, so -1 entries and blocks past pos cost no reads.  A block
// serves all REP query heads of its kv head (each row read once); the
// running max, sum and output stay in fp32 registers, P rounds to bf16
// before it weights V while the sum takes it in fp32, and 1/sqrt(D)
// scales the fp32 dot product (:112-113).  A second launch,
// decode_merge_kernel, combines the chunks' (max, sum, output) by
// log-sum-exp and divides; a chunk with nothing live contributes m = -inf,
// l = 0, o = 0 and so nothing, and a head with nothing live gets 0.
#include "decode_common.cuh"

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kKB = 8;       // positions a warp has in flight

__device__ __forceinline__ float4 to_float4(uint2 u) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Merges the block's warps' running (max, sum, output) of its REP query
// heads and writes them as chunk `split` of heads bh0 .. bh0 + REP - 1
// (part_o (.., ns, kD), part_m / part_l (.., ns)); every thread calls it.
template <int REP>
__device__ __forceinline__ void store_chunk(const float (&m)[REP], const float (&l)[REP],
                                            const float4 (&o)[REP], float* part_o,
                                            float* part_m, float* part_l, long long bh0,
                                            int ns, int split) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __shared__ float sm_m[kWarps][REP], sm_l[kWarps][REP];
  __shared__ __align__(16) float sm_o[kWarps][REP][kD];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
    *reinterpret_cast<float4*>(&sm_o[warp][r][4 * lane]) = o[r];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < REP * kD; idx += kThreads) {
    const int r = idx / kD, d = idx % kD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][r]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = (sm_m[w][r] == -INFINITY) ? 0.f : exp2f(sm_m[w][r] - M);
      L += sm_l[w][r] * c;
      O += sm_o[w][r][d] * c;
    }
    const long long bh = bh0 + r;
    part_o[(bh * ns + split) * kD + d] = O;
    if (d == 0) {
      part_m[bh * ns + split] = M;
      part_l[bh * ns + split] = L;
    }
  }
}

// one block a (head, sequence), one thread a feature
__global__ void __launch_bounds__(kD)
    decode_merge_kernel(const float* __restrict__ part_o, const float* __restrict__ part_m,
                        const float* __restrict__ part_l, bf16* __restrict__ out, int H, int ns) {
  const long long bh = (long long)blockIdx.y * H + blockIdx.x;
  const int d = threadIdx.x;
  float M = -INFINITY;
  for (int s = 0; s < ns; ++s) M = fmaxf(M, part_m[bh * ns + s]);
  float L = 0.f, O = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float pm = part_m[bh * ns + s];
    const float c = (pm == -INFINITY) ? 0.f : exp2f(pm - M);
    L += part_l[bh * ns + s] * c;
    O += part_o[(bh * ns + s) * kD + d] * c;
  }
  if (L == 0.f) L = 1.f;
  out[bh * kD + d] = __float2bfloat16_rn(O / L);
}

constexpr int kMaxCols = 256;  // table columns a block takes, at most

struct PagedParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* tables;  // (B, nb)
  const int* pos;     // (B,)
  float* part_o;      // (B, H, ns, D)
  float* part_m;      // (B, H, ns), base-2 domain
  float* part_l;      // (B, H, ns)
  int H, Hkv, NB, bs, nb, cols, ns;
  float scale_log2;
};

template <int REP>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(PagedParams p) {
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = split * p.cols;
  const int n_cols = min(p.cols, p.nb - c0);
  // positions of this chunk, [c0 * bs, c0 * bs + n_pos), that are <= pos
  const long long first = (long long)c0 * p.bs;
  const int n_pos =
      (int)max(0LL, min((long long)n_cols * p.bs, (long long)p.pos[b] + 1 - first));
  const int h0 = kh * REP;

  __shared__ int tab[kMaxCols];
  for (int i = threadIdx.x; i < n_cols; i += kThreads)
    tab[i] = (n_pos > 0) ? p.tables[(long long)b * p.nb + c0 + i] : -1;
  __syncthreads();

  float m[REP], l[REP];
  float4 o[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    o[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4 q[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r)
    q[r] = to_float4(*reinterpret_cast<const uint2*>(
        p.q + ((long long)b * p.H + h0 + r) * kD + 4 * lane));

  for (int jb = warp * kKB; jb < n_pos; jb += kWarps * kKB) {
    uint2 kr[kKB], vr[kKB];
    bool live[kKB];
#pragma unroll
    for (int i = 0; i < kKB; ++i) {
      kr[i] = vr[i] = make_uint2(0, 0);
      live[i] = false;
      const int j = jb + i;
      if (j < n_pos) {
        const int blk = tab[j / p.bs];
        if (blk >= 0 && blk < p.NB) {
          live[i] = true;
          const long long row = ((long long)blk * p.bs + j % p.bs) * p.Hkv + kh;
          kr[i] = *reinterpret_cast<const uint2*>(p.k + row * kD + 4 * lane);
          vr[i] = *reinterpret_cast<const uint2*>(p.v + row * kD + 4 * lane);
        }
      }
    }
    float s[REP][kKB];
#pragma unroll
    for (int i = 0; i < kKB; ++i) {
      const float4 kf = to_float4(kr[i]);
#pragma unroll
      for (int r = 0; r < REP; ++r)
        s[r][i] = q[r].x * kf.x + q[r].y * kf.y + q[r].z * kf.z + q[r].w * kf.w;
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float mx = m[r];
#pragma unroll
      for (int i = 0; i < kKB; ++i) {
        // live[i] is the same on every lane: the shuffles are warp-uniform
        s[r][i] = live[i] ? warp_sum(s[r][i]) * p.scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[r][i]);
      }
      if (mx == -INFINITY) continue;  // nothing live yet: nothing to add
      const float corr = exp2f(m[r] - mx);
      l[r] *= corr;
      o[r].x *= corr;
      o[r].y *= corr;
      o[r].z *= corr;
      o[r].w *= corr;
#pragma unroll
      for (int i = 0; i < kKB; ++i) {
        const float pe = exp2f(s[r][i] - mx);
        l[r] += pe;
        const float pb = bf16_round(pe);
        const float4 vf = to_float4(vr[i]);
        o[r].x += pb * vf.x;
        o[r].y += pb * vf.y;
        o[r].z += pb * vf.z;
        o[r].w += pb * vf.w;
      }
      m[r] = mx;
    }
  }

  store_chunk<REP>(m, l, o, p.part_o, p.part_m, p.part_l, (long long)b * p.H + h0, p.ns,
                   split);
}

template <int REP>
cudaError_t launch_paged(const PagedParams& p, dim3 grid, cudaStream_t s) {
  paged_split_kernel<REP><<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, 128), pools (NB, bs, Hkv, 128) bf16, tables (B, nb) and pos (B,)
// int32, all contiguous on the device; cols <= 256 table columns a chunk,
// ns = ceil(nb / cols) chunks; part_* the wrapper's fp32 scratch; out
// (B, H, 128) bf16.  H / Hkv must be 1, 2, 4 or 8.
extern "C" int decode_attention_paged_launch(const void* q, const void* k, const void* v,
                                             const void* tables, const void* pos, void* part_o,
                                             void* part_m, void* part_l, void* out, int B,
                                             int H, int Hkv, int NB, int bs, int nb, int cols,
                                             int ns, void* stream) {
  if (cols < 1 || cols > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  PagedParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.tables = static_cast<const int*>(tables);
  p.pos = static_cast<const int*>(pos);
  p.part_o = static_cast<float*>(part_o);
  p.part_m = static_cast<float*>(part_m);
  p.part_l = static_cast<float*>(part_l);
  p.H = H;
  p.Hkv = Hkv;
  p.NB = NB;
  p.bs = bs;
  p.nb = nb;
  p.cols = cols;
  p.ns = ns;
  p.scale_log2 = kLog2e / sqrtf((float)kD);
  const dim3 grid(ns, Hkv, B);
  cudaError_t err;
  switch (H / Hkv) {
    case 1: err = launch_paged<1>(p, grid, s); break;
    case 2: err = launch_paged<2>(p, grid, s); break;
    case 4: err = launch_paged<4>(p, grid, s); break;
    case 8: err = launch_paged<8>(p, grid, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<<<dim3(H, B), kD, 0, s>>>(static_cast<const float*>(part_o),
                                                static_cast<const float*>(part_m),
                                                static_cast<const float*>(part_l),
                                                static_cast<bf16*>(out), H, ns);
  return static_cast<int>(cudaGetLastError());
}
