// decode_attention: flash decoding of one query per sequence over a
// contiguous cache slice.  q (B, H, D) bf16, k / v (B, S, Hkv, D) bf16
// holding global positions [start, start + S), D = 128; sequence b
// attends positions start .. pos (a host int, the same for the batch);
// q head h reads kv head h / (H / Hkv).  out (B, H, D) bf16, normalised,
// 0 where no position is live.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:67
// decode_attention_pallas (body _dec_kernel :25): every attention layer of
// a serving decode step.
//
// Bound on an H100: each live K and V row is read once (a K and a V row
// of 256 bytes a position and kv head), 33.6 MB a layer at batch 4, 2048
// positions and 8 kv heads: 10 us at 3.35 TB/s, so latency counts as much
// as bandwidth.  Design: B * Hkv = 32 (sequence, kv head) pairs are too
// few for 132 SMs, so the live prefix splits into chunks (the wrapper's
// DECODE_CHUNK, 256 positions), one block each, and only the live chunks
// are launched: no block loads past pos (decode_attention.py:37).  A
// block serves all rep query heads of its kv head, so each K / V row is
// read once (:80-81).  Each warp takes kKB positions at a time with all
// their loads in flight, a lane holding 4 of the 128 features; the dot
// products reduce over the warp, and the running max, sum and output stay
// in fp32 registers, P rounding to bf16 before it weights V (:52-54)
// while the sum takes it in fp32.  The block's four warps merge in shared
// memory, and a second small kernel merges the chunks' (max, sum, output)
// by log-sum-exp and divides.
#include "decode_common.cuh"

namespace {

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  float* part_o;  // (B, H, ns, D): each chunk's unnormalised output
  float* part_m;  // (B, H, ns): its max, base-2 domain
  float* part_l;  // (B, H, ns): its sum
  int S, H, Hkv, n_live, ns, chunk;  // chunk: positions a block
  float scale_log2;
};

template <int REP>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(Params p) {
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = split * p.chunk;
  const int j1 = min(j0 + p.chunk, p.n_live);
  const long long row = (long long)p.Hkv * kD;  // elements between positions
  const bf16* kb = p.k + ((long long)b * p.S * p.Hkv + kh) * kD + 4 * lane;
  const bf16* vb = p.v + ((long long)b * p.S * p.Hkv + kh) * kD + 4 * lane;
  const int h0 = kh * REP;

  float4 q[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r)
    q[r] = to_float4(*reinterpret_cast<const uint2*>(
        p.q + ((long long)b * p.H + h0 + r) * kD + 4 * lane));
  float m[REP], l[REP];
  float4 o[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    o[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int jb = j0 + warp * kKB; jb < j1; jb += kWarps * kKB) {
    uint2 kr[kKB], vr[kKB];
#pragma unroll
    for (int i = 0; i < kKB; ++i) {
      kr[i] = vr[i] = make_uint2(0, 0);
      if (jb + i < j1) {
        kr[i] = *reinterpret_cast<const uint2*>(kb + (jb + i) * row);
        vr[i] = *reinterpret_cast<const uint2*>(vb + (jb + i) * row);
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
        s[r][i] = (jb + i < j1) ? warp_sum(s[r][i]) * p.scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[r][i]);
      }
      // position jb is live, so mx is finite
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
cudaError_t launch_split(const Params& p, dim3 grid, cudaStream_t s) {
  decode_split_kernel<REP><<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, 128), k / v (B, S, Hkv, 128) bf16, contiguous; n_live = the
// live positions [0, n_live) of the slice (pos - start + 1, clipped to
// [0, S]); ns = max(1, ceil(n_live / chunk)) chunks of chunk positions;
// part_* the wrapper's fp32 scratch; out (B, H, 128) bf16.  H / Hkv must
// be 1, 2, 4 or 8.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       void* part_o, void* part_m, void* part_l, void* out,
                                       int B, int S, int H, int Hkv, int n_live, int ns,
                                       int chunk, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.part_o = static_cast<float*>(part_o);
  p.part_m = static_cast<float*>(part_m);
  p.part_l = static_cast<float*>(part_l);
  p.S = S;
  p.H = H;
  p.Hkv = Hkv;
  p.n_live = n_live;
  p.ns = ns;
  p.chunk = chunk;
  p.scale_log2 = kLog2e / sqrtf((float)kD);
  const dim3 grid(ns, Hkv, B);
  cudaError_t err;
  switch (H / Hkv) {
    case 1: err = launch_split<1>(p, grid, s); break;
    case 2: err = launch_split<2>(p, grid, s); break;
    case 4: err = launch_split<4>(p, grid, s); break;
    case 8: err = launch_split<8>(p, grid, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<<<dim3(H, B), kD, 0, s>>>(static_cast<const float*>(part_o),
                                                static_cast<const float*>(part_m),
                                                static_cast<const float*>(part_l),
                                                static_cast<bf16*>(out), H, ns);
  return static_cast<int>(cudaGetLastError());
}
