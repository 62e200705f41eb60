// flash_attention: out = softmax(q k^T / sqrt(D) [causal mask]) v per
// (batch, head), q (B, Sq, H, D), k/v (B, Skv, Hkv, D) bf16, D = 128, GQA
// q head h reading kv head h / (H / Hkv); out (B, Sq, H, D) bf16.  The
// causal mask is top-left aligned (query i sees keys 0..i), as in the
// reference.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:68
// flash_attention_pallas (body _fa_kernel :24): every attention layer of
// the serving prefill.
//
// Bound on an H100: at the prefill's shape (2048 positions, 32 heads) the
// causal product takes 2 * B * H * Sq * Skv * D FLOPs (the QK^T and PV
// products over the half of the score matrix the mask keeps), about 2.7x
// what its bytes take at 3.35 TB/s, so the bf16 tensor-core rate bounds it.
// Design, FlashAttention-2's shape: a block per (64-query tile, head,
// batch), four warps of 16 query rows each; K and V tiles of 64 keys are
// staged in shared memory (rows padded by 16 bytes: conflict-free
// fragment loads); QK^T and PV run as bf16 mma.sync.m16n8k16 with fp32
// accumulation, the score fragments turning directly into PV's A operand.
// The running max, sum and output stay in fp32 registers.  Kept from the
// TPU kernel: P rounds to bf16 before the PV product (:52-54) while the
// sum takes it in fp32; kv tiles strictly above the diagonal are never
// loaded (:33); rows whose max is still -inf use m = 0 (:46); l == 0
// gives 1 (:61-62).  Ragged Sq / Skv load zeros past the end and mask
// those keys.  Query tiles run longest first, so the causal tail is short.
// A first version: loads are not overlapped with the MMAs (no cp.async or
// TMA pipeline, no wgmma); its time stands in PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kD = 128;             // head dim (the wrapper refuses others)
constexpr int kBQ = 64;             // query rows a block
constexpr int kBK = 64;             // keys a tile
constexpr int kThreads = 128;       // 4 warps x 16 rows
constexpr int kStride = kD + 8;     // shared row stride in elements (272 bytes)
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;  // strides (elements)
  int Sq, Skv, H, rep, causal;
  float scale_log2;  // log2(e) / sqrt(D): scores in the base-2 domain
};

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices, transposed: lanes 8i..8i+7 give matrix i's rows
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (lo, hi) -> one register of two bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows row0 .. row0+63 of one head into dst; rows at or past n_rows are zeros
__device__ __forceinline__ void load_tile(bf16 (*dst)[kStride], const bf16* src,
                                          long long row_stride, int row0, int n_rows) {
  for (int i = threadIdx.x; i < kBK * (kD / 8); i += kThreads) {
    const int r = i >> 4, c = (i & 15) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows)
      v = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = v;
  }
}

__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  __shared__ __align__(16) bf16 Ks[kBK][kStride];
  __shared__ __align__(16) bf16 Vs[kBK][kStride];

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / p.rep;
  const bf16* qp = p.q + b * p.qsb + h * p.qsh;
  const bf16* kp = p.k + b * p.ksb + kh * p.ksh;
  const bf16* vp = p.v + b * p.vsb + kh * p.vsh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column pair
  const int wr = warp * 16;

  // the warp's 16 query rows as mma A fragments, staged through Ks
  load_tile(Ks, qp, p.qss, q0, p.Sq);
  __syncthreads();
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = ld32(&Ks[wr + g][c]);
    qf[kk][1] = ld32(&Ks[wr + g + 8][c]);
    qf[kk][2] = ld32(&Ks[wr + g][c + 8]);
    qf[kk][3] = ld32(&Ks[wr + g + 8][c + 8]);
  }
  __syncthreads();

  // this thread's two rows (g and g + 8 of the warp): running max, sum
  // (a partial over its columns, summed over the quad at the end), output
  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};

  int n_tiles = (p.Skv + kBK - 1) / kBK;
  if (p.causal) n_tiles = min(n_tiles, q0 / kBK + 1);  // none above the diagonal
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    load_tile(Ks, kp, p.kss, k0, p.Skv);
    load_tile(Vs, vp, p.vss, k0, p.Skv);
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
        mma16816(s[n], qf[kk], ld32(&Ks[n * 8 + g][c]), ld32(&Ks[n * 8 + g][c + 8]));
    }

    // mask, then the new running max of each row over the quad's columns
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const bool live = key < p.Skv && (!p.causal || key <= rows[e >> 1]);
        const float v = live ? s[n][e] * p.scale_log2 : -INFINITY;
        s[n][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float ms[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      ms[i] = (mx[i] == -INFINITY) ? 0.f : mx[i];
      const float corr = exp2f(m[i] - ms[i]);
      l[i] *= corr;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        o[n][2 * i] *= corr;
        o[n][2 * i + 1] *= corr;
      }
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[n][e] - ms[e >> 1]);
        s[n][e] = pe;
        l[e >> 1] += pe;
      }

    // o += bf16(P) V: score n-tiles 2kk, 2kk+1 are the A fragment of key step kk
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < kD / 8; nd += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, &Vs[kk * 16 + (lane & 15)][nd * 8 + (lane >> 4) * 8]);
        mma16816(o[nd], a, bv[0], bv[1]);
        mma16816(o[nd + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();
  }

  bf16* op = p.out + ((long long)b * p.Sq * p.H + h) * kD;
  const long long oss = (long long)p.H * kD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float li = (l[i] == 0.f) ? 1.f : l[i];
    if (rows[i] >= p.Sq) continue;
    bf16* orow = op + rows[i] * oss + 2 * t;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(o[n][2 * i] / li, o[n][2 * i + 1] / li);
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = v;
    }
  }
}

}  // namespace

// q (B, Sq, H, 128), k / v (B, Skv, Hkv, 128) bf16 with unit last stride
// and the other strides (in elements) given; out (B, Sq, H, 128)
// contiguous.  Every row start must be 16-byte aligned (the wrapper checks).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int Sq, int Skv, int H, int Hkv, int causal,
                                      long long qsb, long long qss, long long qsh,
                                      long long ksb, long long kss, long long ksh,
                                      long long vsb, long long vss, long long vsh,
                                      void* stream) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.out = static_cast<bf16*>(out);
  p.qsb = qsb; p.qss = qss; p.qsh = qsh;
  p.ksb = ksb; p.kss = kss; p.ksh = ksh;
  p.vsb = vsb; p.vss = vss; p.vsh = vsh;
  p.Sq = Sq;
  p.Skv = Skv;
  p.H = H;
  p.rep = H / Hkv;
  p.causal = causal;
  p.scale_log2 = kLog2e / sqrtf((float)kD);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
