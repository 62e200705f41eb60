// decode_attention: flash decoding of one query per sequence over a
// contiguous cache slice, in one launch.  q (B, H, D) bf16, k / v (B, S,
// Hkv, D) bf16 holding global positions [start, start + S), D 64 or 128; pos a
// 0-d int32 on the device, the same for the batch: sequence b attends
// positions start .. pos; q head h reads kv head h / (H / Hkv).  out (B, H,
// D) bf16, normalised, 0 where no position is live.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:67
// decode_attention_pallas (body _dec_kernel :25): every attention layer of
// a serving decode step.  As there (a scalar-prefetch operand, :96), pos is
// read on the device: nothing about the launch depends on it, so a CUDA
// graph captures the launch once and replays it at every position.  The
// kernel is decode_common.cuh's, which also says how it is built; here is
// only the map from a position to its cache row, SliceRows: position j of
// sequence b is row j of its slice, live when start + j <= pos.  As in the
// TPU kernel (:37), a chunk that starts past pos reads nothing.
#include "decode_common.cuh"

namespace {

template <int D>
struct SliceRows {
  const bf16* kb;
  const bf16* vb;
  long long row;  // elements between positions

  static __device__ __forceinline__ int n_live(const Params& p, int) {
    return min(max(__ldg(p.pos) - p.start + 1, 0), p.S);
  }

  __device__ __forceinline__ SliceRows(const Params& p, int b, int kh, int gl, int)
      : row((long long)p.Hkv * D) {
    const long long base = ((long long)b * p.S * p.Hkv + kh) * D + 8 * gl;
    kb = p.k + base;
    vb = p.v + base;
  }

  // recomputed, which keeps the copies' bits out of the loop
  template <int U>
  __device__ __forceinline__ unsigned live(int j, int j1, unsigned) const {
    unsigned l = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) l |= static_cast<unsigned>(j + u < j1) << u;
    return l;
  }

  template <int U>
  __device__ __forceinline__ unsigned at(int j, int j1, long long (&off)[U]) const {
    unsigned live = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool l = j + u < j1;
      off[u] = l ? (j + u) * row : 0;
      live |= static_cast<unsigned>(l) << u;
    }
    return live;
  }
};

}  // namespace

// Resident blocks an SM holds of the kernel for rep query heads a kv head
// at head dim D (0 for a rep or D it does not take, or on error).
extern "C" int decode_attention_blocks_per_sm(int rep, int D) {
  return blocks_per_sm<SliceRows>(rep, D);
}

// q (B, H, D), k / v (B, S, Hkv, D) bf16, contiguous; pos a 0-d int32
// on the device, global; start the slice's first global position; ns
// chunks of chunk positions cover S (ns * chunk >= S, ns >= 1); part_o
// (B, H, ns, D) and part_ml (2, B, H, ns) the wrapper's fp32 scratch;
// arrivals (B * Hkv) int32, zero, and zero again after the launch; out (B,
// H, D) bf16.  D must be 64 or 128, H / Hkv 1, 2, 4, 6 or 8.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* pos, void* part_o, void* part_ml,
                                       void* arrivals, void* out, int B, int S, int H, int Hkv,
                                       int D, int start, int ns, int chunk, void* stream) {
  if (ns < 1 || chunk < 1 || (long long)ns * chunk < S)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.pos = static_cast<const int*>(pos);
  p.part_o = static_cast<float*>(part_o);
  p.part_m = static_cast<float*>(part_ml);
  p.part_l = p.part_m + (long long)B * H * ns;
  p.arrivals = static_cast<int*>(arrivals);
  p.out = static_cast<bf16*>(out);
  p.H = H;
  p.Hkv = Hkv;
  p.ns = ns;
  p.chunk = chunk;
  p.S = S;
  p.start = start;
  p.scale_log2 = kLog2e / sqrtf((float)D);
  return launch<SliceRows>(p, B, D, reinterpret_cast<cudaStream_t>(stream));
}
