// mla_decode: absorbed multi-head latent attention decoding, one query a
// head and a sequence over the latent cache, in one launch.  q (B, 16,
// 576) bf16 holds each head's absorbed query ([q_nope . W_uk, q_pe]), the
// cache (B, S, 576) bf16 one row a position ([c (512), k_pe (64)]); head
// h's score at position j is q[b, h] . cache[b, j] over all 576 columns
// (times the softmax scale), its value the row's first 512 columns.  pos
// a 0-d int32 on the device, the same for the batch: positions 0 .. pos
// are live.  out (B, 16, 512) bf16, normalised, 0 where nothing is live.
//
// Replaces no TPU kernel: the JAX package has no MLA.  Added for
// Moonlight-16B-A3B's decode step (models/mla.py), where the 16 heads
// share one 576-wide key row whose first 512 values are also the value.
//
// Bound on an H100: bytes, narrowly.  A live position reads one row of
// 1,152 bytes and costs 2 x 16 x (576 + 512) = 34,816 FLOP, ~30 FLOP a
// byte: above fp32's ridge (67 TFLOP/s over 3.35 TB/s = 20), so only the
// tensor cores keep the arithmetic under the bytes (bf16's ridge is 295).
// So the design:
// - the 16 heads are the M = 16 of mma.sync m16n8k16 tiles (bf16 in,
//   fp32 sums): the scores S = Q K^T (16 x 64 positions a tile, K = 576)
//   and the output O += P V (16 x 512, K = 64 positions a tile);
// - a block takes one sequence's chunk of positions (grid (ns, B), ns
//   from the shapes and the card alone: one block a sequence where the
//   batch fills the SMs, kernels/mla.py's mla_chunk), 4 warps.  The rows
//   land by cp.async, 64 a tile, in a 2-tile ring in shared memory (a row
//   padded to 1,168 bytes, so that ldmatrix's 8 rows fall in 8 banks); the
//   next tile's copies are in flight while a tile is used.  A dead row
//   (past pos, or past the cache) is copied with src-size 0: it reads
//   nothing, lands as zeros and scores -inf;
// - each warp scores 16 of a tile's 64 positions for all 16 heads (36
//   k-steps of ldmatrix'd Q and K fragments), the scores meet in shared
//   memory, 8 threads a head take the tile's max and sum (the running
//   max, sum and the correction in shared memory, base 2), P rounds to
//   bf16 for the product while the sum takes it in fp32 (the decoders'
//   arithmetic), and each warp keeps 128 of the 512 output columns in
//   fp32 registers (64 a thread), its V fragments by ldmatrix.trans;
// - with one chunk a sequence the block writes the normalised output;
//   with more, each writes its chunk's (max, sum, output), and the last
//   block of a sequence to arrive (an atomic counter) merges the chunks
//   that hold a live position by log-sum-exp, writes the output and sets
//   the counter back to 0, as decode_common.cuh's kernel does, so that a
//   CUDA graph replays the launch with no memset.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kH = 16;                 // heads: mma.sync's M
constexpr int kDk = 576;               // a row: the latent and k_pe
constexpr int kDv = 512;               // the value: the latent
constexpr int kTile = 64;              // positions a tile
constexpr int kThreads = 128;
constexpr int kWarpCols = kDv / (kThreads / 32);  // output columns a warp
constexpr int kUnits = kDk / 8;        // 16-byte units a row
constexpr int kRowBytes = (kDk + 8) * 2;  // a padded shared row
constexpr int kSStride = kTile + 4;    // fp32 scores a head
constexpr int kPStride = kTile + 8;    // bf16 P a head (144 bytes)
constexpr int kQBytes = kH * kRowBytes;
constexpr int kTileBytes = kTile * kRowBytes;
constexpr int kSBytes = kH * kSStride * 4;
constexpr int kPBytes = kH * kPStride * 2;
constexpr int kSmemBytes = kQBytes + 2 * kTileBytes + kSBytes + kPBytes + 3 * kH * 4;
static_assert(kRowBytes % 16 == 0 && (kRowBytes / 16) % 8 == 1, "rows a bank apart");
static_assert((kPStride * 2) % 16 == 0, "P rows 16-byte aligned");
static_assert(kWarpCols == 128 && kTile == 4 * 16, "four warps");

struct Params {
  const bf16* q;
  const bf16* cache;
  const int* pos;     // 0-d, global
  float* part_o;      // (B, H, ns, Dv): each chunk's unnormalised output
  float* part_m;      // (B, H, ns): its max, base-2 domain
  float* part_l;      // (B, H, ns): its sum
  int* arrivals;      // (B,): blocks done, 0 between launches
  bf16* out;
  int S, ns, chunk;
  float scale_log2;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n"); }

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a (16 x 16, row) b (16 x 8, col), bf16 in, fp32 sums
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the rows first .. first + kTile - 1 of sequence b into a ring slot,
// those at or past j1 zero-filled
__device__ __forceinline__ void load_tile(unsigned char* slot, const bf16* seq, int first,
                                          int j1, int tid) {
#pragma unroll 4
  for (int u = tid; u < kTile * kUnits; u += kThreads) {
    const int r = u / kUnits, c = u % kUnits;
    const bool live = first + r < j1;
    const bf16* src = seq + (long long)(live ? first + r : 0) * kDk + 8 * c;
    cp_async16(slot + r * kRowBytes + 16 * c, src, live);
  }
}

__global__ void __launch_bounds__(kThreads, 1) mla_decode_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const sQ = smem;
  unsigned char* const sKV = smem + kQBytes;
  float* const sS = reinterpret_cast<float*>(sKV + 2 * kTileBytes);
  bf16* const sP = reinterpret_cast<bf16*>(smem + kQBytes + 2 * kTileBytes + kSBytes);
  float* const sM = reinterpret_cast<float*>(smem + kQBytes + 2 * kTileBytes + kSBytes + kPBytes);
  float* const sL = sM + kH;
  float* const sC = sL + kH;

  const int split = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;  // an mma fragment's row and column pair
  const int n_live = min(max(__ldg(p.pos) + 1, 0), p.S);
  const int j0 = split * p.chunk;
  const int j1 = min(j0 + p.chunk, n_live);
  const long long bh0 = (long long)b * kH;
  const bf16* const seq = p.cache + (long long)b * p.S * kDk;

  float o[kWarpCols / 8][4];
#pragma unroll
  for (int nt = 0; nt < kWarpCols / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nt][i] = 0.f;

  if (j0 < j1) {
    for (int u = tid; u < kH * kUnits; u += kThreads) {
      const int r = u / kUnits, c = u % kUnits;
      cp_async16(sQ + r * kRowBytes + 16 * c, p.q + (bh0 + r) * kDk + 8 * c, true);
    }
    load_tile(sKV, seq, j0, j1, tid);
    cp_async_commit();
    if (tid < kH) {
      sM[tid] = -INFINITY;
      sL[tid] = 0.f;
    }
    const int n_tiles = (j1 - j0 + kTile - 1) / kTile;
    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait_all();
      __syncthreads();  // tile t is everyone's; the other slot is free
      if (t + 1 < n_tiles) load_tile(sKV + ((t + 1) & 1) * kTileBytes, seq, j0 + (t + 1) * kTile,
                                     j1, tid);
      cp_async_commit();
      const unsigned char* const kv = sKV + (t & 1) * kTileBytes;
      const int base = j0 + t * kTile;

      // scores of this warp's 16 positions, all heads
      float sc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[nt][i] = 0.f;
      const unsigned char* const qa =
          sQ + (lane % 8 + ((lane >> 3) & 1) * 8) * kRowBytes + (lane >> 4) * 16;
      const unsigned char* const kb =
          kv + (warp * 16 + lane % 8 + (lane >> 4) * 8) * kRowBytes + ((lane >> 3) & 1) * 16;
#pragma unroll 4
      for (int kk = 0; kk < kDk / 16; ++kk) {
        unsigned a[4], bk[4];
        ldmatrix_x4(a, qa + kk * 32);
        ldmatrix_x4(bk, kb + kk * 32);
        mma16816(sc[0], a, bk[0], bk[1]);
        mma16816(sc[1], a, bk[2], bk[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c0 = warp * 16 + nt * 8 + 2 * tq;
          const float v0 = base + c0 < j1 ? sc[nt][2 * half] * p.scale_log2 : -INFINITY;
          const float v1 = base + c0 + 1 < j1 ? sc[nt][2 * half + 1] * p.scale_log2 : -INFINITY;
          *reinterpret_cast<float2*>(sS + (g + 8 * half) * kSStride + c0) = make_float2(v0, v1);
        }
      __syncthreads();

      // the tile's softmax, 8 threads a head (neighbouring lanes)
      {
        const int h = tid >> 3, seg = tid & 7;
        float s8[8], mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s8[i] = sS[h * kSStride + 8 * seg + i];
          mx = fmaxf(mx, s8[i]);
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = sM[h];
        const float m_new = fmaxf(m_old, mx);
        const float ms = (m_new == -INFINITY) ? 0.f : m_new;
        float sum = 0.f;
        unsigned pk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p0 = exp2f(s8[2 * i] - ms), p1 = exp2f(s8[2 * i + 1] - ms);  // 0 if dead
          sum += p0;
          sum += p1;
          const __nv_bfloat162 two = __floats2bfloat162_rn(p0, p1);
          pk[i] = *reinterpret_cast<const unsigned*>(&two);
        }
        *reinterpret_cast<uint4*>(sP + h * kPStride + 8 * seg) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        __syncwarp();
        if (seg == 0) {
          const float corr = exp2f(m_old - ms);
          sM[h] = m_new;
          sL[h] = sL[h] * corr + sum;
          sC[h] = corr;
        }
      }
      __syncthreads();

      // O = O corr + P V over this warp's 128 columns
      const float c_lo = sC[g], c_hi = sC[g + 8];
#pragma unroll
      for (int nt = 0; nt < kWarpCols / 8; ++nt) {
        o[nt][0] *= c_lo;
        o[nt][1] *= c_lo;
        o[nt][2] *= c_hi;
        o[nt][3] *= c_hi;
      }
      const bf16* const pa = sP + (lane % 8 + ((lane >> 3) & 1) * 8) * kPStride + (lane >> 4) * 8;
      const unsigned char* const vb = kv + (lane % 8 + ((lane >> 3) & 1) * 8) * kRowBytes +
                                      (warp * kWarpCols + (lane >> 4) * 8) * 2;
#pragma unroll
      for (int ks = 0; ks < kTile / 16; ++ks) {
        unsigned a[4];
        ldmatrix_x4(a, pa + ks * 16);
#pragma unroll
        for (int np = 0; np < kWarpCols / 16; ++np) {
          unsigned bv[4];
          ldmatrix_x4_trans(bv, vb + ks * 16 * kRowBytes + np * 32);
          mma16816(o[2 * np], a, bv[0], bv[1]);
          mma16816(o[2 * np + 1], a, bv[2], bv[3]);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the last tile's sum in sL

    if (p.ns == 1) {
      const float l_lo = sL[g] == 0.f ? 1.f : sL[g];
      const float l_hi = sL[g + 8] == 0.f ? 1.f : sL[g + 8];
#pragma unroll
      for (int nt = 0; nt < kWarpCols / 8; ++nt) {
        const int col = warp * kWarpCols + nt * 8 + 2 * tq;
        *reinterpret_cast<__nv_bfloat162*>(p.out + (bh0 + g) * kDv + col) =
            __floats2bfloat162_rn(o[nt][0] / l_lo, o[nt][1] / l_lo);
        *reinterpret_cast<__nv_bfloat162*>(p.out + (bh0 + g + 8) * kDv + col) =
            __floats2bfloat162_rn(o[nt][2] / l_hi, o[nt][3] / l_hi);
      }
      return;
    }
    const int ns = p.ns;
#pragma unroll
    for (int nt = 0; nt < kWarpCols / 8; ++nt) {
      const int col = warp * kWarpCols + nt * 8 + 2 * tq;
      *reinterpret_cast<float2*>(p.part_o + ((bh0 + g) * ns + split) * kDv + col) =
          make_float2(o[nt][0], o[nt][1]);
      *reinterpret_cast<float2*>(p.part_o + ((bh0 + g + 8) * ns + split) * kDv + col) =
          make_float2(o[nt][2], o[nt][3]);
    }
    if (tid < kH) {
      p.part_m[(bh0 + tid) * ns + split] = sM[tid];
      p.part_l[(bh0 + tid) * ns + split] = sL[tid];
    }
  } else if (p.ns == 1) {
    // nothing is live (S == 0 is refused by the wrapper; pos < 0 here)
    for (int i = tid; i < kH * kDv; i += kThreads) p.out[bh0 * kDv + i] = __float2bfloat16_rn(0.f);
    return;
  }
  // a chunk past the live positions writes nothing: the merge reads only
  // the chunks that hold one

  // arrive; the last of the sequence's ns blocks merges
  int* const counter = p.arrivals + b;
  __threadfence();
  __syncthreads();
  int arrived = 0;
  if (tid == 0) arrived = atomicAdd(counter, 1);
  if (!__syncthreads_or(tid == 0 && arrived == p.ns - 1)) return;
  __threadfence();
  const int ns = p.ns;
  const int n_chunks = (n_live + p.chunk - 1) / p.chunk;
  for (int idx = tid; idx < kH * kDv; idx += kThreads) {
    const int h = idx / kDv, d = idx % kDv;
    const long long row = (bh0 + h) * ns;
    float M = -INFINITY, L = 0.f, O = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const float mc = __ldcg(p.part_m + row + c);
      const float lc = __ldcg(p.part_l + row + c);
      const float oc = __ldcg(p.part_o + (row + c) * kDv + d);
      const float mn = fmaxf(M, mc);
      const float msafe = (mn == -INFINITY) ? 0.f : mn;
      const float a = exp2f(M - msafe), w = exp2f(mc - msafe);
      L = L * a + lc * w;
      O = O * a + oc * w;
      M = mn;
    }
    p.out[(bh0 + h) * kDv + d] = __float2bfloat16_rn(O / (L == 0.f ? 1.f : L));
  }
  if (tid == 0) *counter = 0;
}

}  // namespace

// q (B, 16, 576), cache (B, S, 576) bf16, contiguous; pos a 0-d int32 on
// the device; ns chunks of chunk positions (a multiple of 64) cover S;
// with ns > 1, part_o (B, 16, ns, 512) and part_ml (2, B, 16, ns) fp32
// scratch and arrivals (B,) int32, zero, and zero again after the launch;
// out (B, 16, 512) bf16.  scale_log2: the softmax scale times log2(e).
extern "C" int mla_decode_launch(const void* q, const void* cache, const void* pos,
                                 void* part_o, void* part_ml, void* arrivals, void* out, int B,
                                 int S, int ns, int chunk, float scale_log2, void* stream) {
  if (B < 1 || S < 1 || ns < 1 || chunk < 1 || chunk % kTile || (long long)ns * chunk < S)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  Params p{};
  p.q = static_cast<const bf16*>(q);
  p.cache = static_cast<const bf16*>(cache);
  p.pos = static_cast<const int*>(pos);
  p.part_o = static_cast<float*>(part_o);
  p.part_m = static_cast<float*>(part_ml);
  p.part_l = p.part_m + (long long)B * kH * ns;
  p.arrivals = static_cast<int*>(arrivals);
  p.out = static_cast<bf16*>(out);
  p.S = S;
  p.ns = ns;
  p.chunk = chunk;
  p.scale_log2 = scale_log2;
  mla_decode_kernel<<<dim3(ns, B), kThreads, kSmemBytes, reinterpret_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
