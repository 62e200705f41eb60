// flash_attention: out = softmax(q k^T / sqrt(D) [causal mask]) v per
// (batch, head), q (B, Sq, H, D), k/v (B, Skv, Hkv, D) bf16, D 64 or
// 128, GQA q head h reading kv head h / (H / Hkv) (any rep); out (B, Sq,
// H, D) bf16.  The causal mask is top-left aligned (query i sees keys
// 0..i), as in the reference.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:68
// flash_attention_pallas (body _fa_kernel :24): every attention layer of
// the serving prefill.
//
// Bound on an H100: at the prefill's shape (2048 positions, 32 heads) the
// causal product takes 2 * B * H * Sq * Skv * D FLOPs (the QK^T and PV
// products over the half of the score matrix the mask keeps), about 2.7x
// what its bytes take at 3.35 TB/s, so the bf16 tensor-core rate bounds it;
// the exponentials (one per kept score, 16 a clock on an SM's special
// function units) take half as long as the products, and only
// overlapping them with the products keeps the tensor cores busy.
//
// Design (FlashAttention-3's shape): a block of three warpgroups per
// 128-query tile of one (head, batch).  Warpgroup 0 is the producer: one
// thread loads the q tile once and then streams 128-key K and V tiles into
// a ring of kStages shared-memory stages with TMA (cp.async.bulk.tensor
// over 4-D tensor maps of the strided q/k/v views, 128-byte swizzle,
// completion on mbarriers), waiting on each stage's "empty" barrier before
// it refills it, so that later tiles load while earlier ones multiply.
// Warpgroups 1 and 2 are consumers of 64 query rows each: S = Q K^T runs
// as D / 16 wgmma.m64n128k16 with both operands read from shared memory by
// descriptor (K-major, 128-byte swizzle); the online softmax runs on the
// fp32 accumulator in registers; P, rounded to bf16 pairs, is laid out as
// wgmma's register A fragment, and O += P V runs as eight register-A
// wgmma.m64nDk16 with V read from shared memory in MN-major (transposed)
// form.  Two overlaps keep the tensor cores busy while the exponentials
// run: within a consumer, tile j's scores are issued together with tile
// j - 1's PV product, and tile j's softmax runs while that product does
// (O is rescaled after it); and the two consumers' products and softmaxes
// interleave on the SM.  setmaxnreg moves registers from the
// producer (24) to the consumers (240: S and O accumulators of 64 fp32
// each at D = 128, O's 32 at D = 64; P's 32 registers).  The output is staged through the consumer's
// own q rows in shared memory and written with coalesced 16-byte stores.
// Query tiles run longest first over the whole grid (the causal tail is
// short).  About half the bound at the qwen3 prefill; neither a
// persistent grid (the q load under the previous tile's epilogue) nor
// consumers taking turns to issue (named barriers) was faster, and
// neither the exponentials nor the K/V feed bounds it (timing variants
// without either ran barely faster): each query tile's first QK and last
// PV overlap nothing, and on the diagonal tile the first consumer
// multiplies a half that is all masked.
//
// TMA rather than cp.async: the hardware writes the 128-byte swizzle that
// wgmma's descriptors read, and the loads cost the consumers no registers
// or instructions.  The tensor maps come from cuTensorMapEncodeTiled, got
// from the driver through cudaGetDriverEntryPoint, so the library needs no
// link against libcuda; that encoder, the mbarrier, TMA, descriptor and
// wgmma helpers live in hopper_common.cuh, shared with swiglu_tiles.cuh.
// Each view's outer dims (s, h, b) enter the map in ascending stride order
// (an extent-1 dim last), and the kernel permutes its coordinates to match.
//
// The head dim is a template parameter, D = 128 (qwen3, phi3, qwen2-72b,
// internvl2, moonshot, qwen2-moe) or 64 (musicgen-large): a q, K or V tile
// is D / 64 swizzle halves of 64 columns (one at D = 64, whose TMA box is
// then the whole row), QK^T takes D / 16 k16 steps, PV runs as
// m64n64k16 at D = 64 with half the O registers, the epilogue writes D / 8
// chunks of 16 bytes a row.  The D = 128 instantiation is the kernel as it
// was before D became a parameter, bit for bit.
//
// Kept from the TPU kernel: P rounds to bf16 before the PV product (:52-54)
// while the sum l takes it in fp32; kv tiles strictly above the diagonal
// are never loaded (:33); a row whose max is still -inf uses m = 0 (:46);
// l == 0 gives 1 (:61-62).  Ragged Sq / Skv: TMA fills rows past the end
// with zeros, and the keys past Skv are masked.
#include <math.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;
using hopper::fence_regs;  // overloaded below for P's registers
using bf16 = __nv_bfloat16;
constexpr int kBQ = 128;             // query rows a block: two consumers of 64
constexpr int kBK = 128;             // keys a tile
constexpr int kStages = 3;           // K/V ring depth
constexpr int kThreads = 384;        // producer + two consumer warpgroups
constexpr int kRowBytes = 128;       // one swizzle row: 64 head-dim columns
constexpr int kHalfBytes = kBK * kRowBytes;       // 16 KB: a 64-column half
constexpr int kNumBars = 1 + 3 * kStages;         // q, full K, full V, empty
constexpr float kLog2e = 1.4426950408889634f;

// shared memory and registers at head dim D
template <int D>
struct Layout {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static constexpr int kHalves = D / 64;                    // halves a tile
  static constexpr int kTileBytes = kHalves * kHalfBytes;   // a K or V tile
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kOffK = kQBytes;
  static constexpr int kOffV = kOffK + kStages * kTileBytes;
  static constexpr int kOffBar = kOffV + kStages * kTileBytes;
  static constexpr int kSmemBytes = kOffBar + 8 * kNumBars + 1024;  // + alignment
  static constexpr int kOut = D / 2;  // O's fp32 registers a consumer thread
  static constexpr int kChunks = D / 8;  // 16-byte chunks an output row
  static_assert(kQBytes == kTileBytes, "q and kv tiles share the half stride");
};

struct Params {
  bf16* out;
  int B, Sq, Skv, H, rep, causal, n_qt;
  int qperm[3], kperm[3], vperm[3];  // map dim 1 + i is (s, h, b)[perm[i]]
  float scale_log2;                  // log2(e) / sqrt(D)
};

// pins P's registers as hopper::fence_regs pins an accumulator: the PV
// product reads them asynchronously, so the next tile's P must not be
// written into them before the wait
__device__ __forceinline__ void fence_regs(uint32_t (&r)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One tile's online softmax on the S accumulator, in place: masks (when
// ``masked``) keys past Skv and, causal, past each row; updates the
// running max m (base-2 domain, scaled) of this thread's rows row0 and
// row0 + 8; leaves P = 2^(s * scale - m) in s (fp32), the factor that
// rescales the older sums in corr, and P's row sums over this thread's
// columns in sum.
__device__ __forceinline__ void online_softmax(float (&s)[64], float (&m)[2], float (&corr)[2],
                                               float (&sum)[2], float scale_log2, bool masked,
                                               int k0, int row0, int Skv, int causal, int t) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * i + 2 * t + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        if (key >= Skv || (causal && key > row)) s[4 * i + e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * i], s[4 * i + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  float ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float n = fmaxf(m[r], mx[r] * scale_log2);
    ms[r] = (n == -INFINITY) ? 0.f : n;  // a row with no live key yet: m = 0
    corr[r] = ex2(m[r] - ms[r]);
    m[r] = n;
    sum[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = ex2(fmaf(s[4 * i + e], scale_log2, -ms[e >> 1]));
      s[4 * i + e] = pe;
      sum[e >> 1] += pe;
    }
}

// (lo, hi) -> one register of two bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ int pick(int which, int s, int h, int b) {
  return which == 0 ? s : (which == 1 ? h : b);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms want 1024-byte alignment
  uint8_t* const smem = smem_raw + (base - raw);
  using Lt = Layout<D>;
  const uint32_t q_bar = base + Lt::kOffBar;
  const uint32_t full_k = q_bar + 8, full_v = full_k + 8 * kStages,
                 empty = full_v + 8 * kStages;

  // longest causal tiles first over the whole grid
  const int hb = blockIdx.x % (p.H * p.B);
  const int qt = p.n_qt - 1 - blockIdx.x / (p.H * p.B);
  const int h = hb % p.H, b = hb / p.H, kh = h / p.rep;
  const int q0 = qt * kBQ;
  int n_tiles = (p.Skv + kBK - 1) / kBK;
  if (p.causal) n_tiles = min(n_tiles, q0 / kBK + 1);  // none above the diagonal

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, Lt::kQBytes);
      for (int half = 0; half < Lt::kHalves; ++half)
        tma_load_4d(base + half * kHalfBytes, &tq, q_bar, half * 64,
                    pick(p.qperm[0], q0, h, b), pick(p.qperm[1], q0, h, b),
                    pick(p.qperm[2], q0, h, b));
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(empty + 8 * st, ((j / kStages) - 1) & 1);
        const int k0 = j * kBK;
        const uint32_t kd = base + Lt::kOffK + st * Lt::kTileBytes,
                       vd = base + Lt::kOffV + st * Lt::kTileBytes;
        mbar_expect_tx(full_k + 8 * st, Lt::kTileBytes);
        for (int half = 0; half < Lt::kHalves; ++half)
          tma_load_4d(kd + half * kHalfBytes, &tk, full_k + 8 * st, half * 64,
                      pick(p.kperm[0], k0, kh, b), pick(p.kperm[1], k0, kh, b),
                      pick(p.kperm[2], k0, kh, b));
        mbar_expect_tx(full_v + 8 * st, Lt::kTileBytes);
        for (int half = 0; half < Lt::kHalves; ++half)
          tma_load_4d(vd + half * kHalfBytes, &tv, full_v + 8 * st, half * 64,
                      pick(p.vperm[0], k0, kh, b), pick(p.vperm[1], k0, kh, b),
                      pick(p.vperm[2], k0, kh, b));
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;                       // consumer 0 / 1: rows 64c..64c+63
  const int tid = threadIdx.x % 128;
  const int w4 = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;       // accumulator row group, column pair
  const int rl = 16 * w4 + g;                 // this thread's first row in the 64
  const int row0 = q0 + 64 * c + rl;
  const uint32_t q_base = base + c * 64 * kRowBytes;

  float o[Lt::kOut], s[64];
  uint32_t pa[8][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < Lt::kOut; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2], sum[2];

  // S = Q K^T of tile j over the head dim: D / 16 steps of 16, 4 in each
  // half
  auto issue_qk = [&](int j) {
    const uint32_t kb = base + Lt::kOffK + (j % kStages) * Lt::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kHalfBytes + (kk & 3) * 32;
      wgmma_ss(s, desc_sw128(q_base + off, 16, 1024), desc_sw128(kb + off, 16, 1024), kk > 0);
    }
    wg_commit();
  };
  // O += bf16(P) V of tile j: 8 steps of 16 keys, n = D
  auto issue_pv = [&](int j) {
    const uint32_t vb = base + Lt::kOffV + (j % kStages) * Lt::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t dv = desc_sw128(vb + kk * 16 * kRowBytes, kHalfBytes, 1024);
      if constexpr (D == 128)
        wgmma_rs(o, pa[kk], dv);
      else
        wgmma_rs_n64(o, pa[kk], dv);
    }
    wg_commit();
  };
  auto softmax = [&](int j) {
    const int k0 = j * kBK;
    online_softmax(s, m, corr, sum, p.scale_log2,
                   k0 + kBK > p.Skv || (p.causal && k0 + kBK - 1 > q0 + 64 * c), k0, row0,
                   p.Skv, p.causal, t);
  };
  auto pack_p = [&]() {
    // score chunks 2kk, 2kk+1 are the A fragment of key step kk
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  auto full = [&](uint32_t bars, int j) {
    mbar_wait(bars + 8 * (j % kStages), (j / kStages) & 1);
  };

  mbar_wait(q_bar, 0);
  if (n_tiles > 0) {
    full(full_k, 0);
    wg_fence();
    issue_qk(0);
    wg_wait<0>();
    fence_regs(s);
    softmax(0);
    l[0] = sum[0];
    l[1] = sum[1];
    pack_p();
    // tile j's scores and softmax overlap tile j - 1's PV product
    for (int j = 1; j < n_tiles; ++j) {
      full(full_k, j);
      fence_regs(s);
      fence_regs(o);
      wg_fence();
      issue_qk(j);
      full(full_v, j - 1);
      issue_pv(j - 1);
      wg_wait<1>();  // the scores; the PV product may still run
      fence_regs(s);
      softmax(j);
      wg_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(empty + 8 * ((j - 1) % kStages));
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= corr[0];
        o[4 * i + 1] *= corr[0];
        o[4 * i + 2] *= corr[1];
        o[4 * i + 3] *= corr[1];
      }
      l[0] = l[0] * corr[0] + sum[0];
      l[1] = l[1] * corr[1] + sum[1];
      pack_p();
    }
    full(full_v, n_tiles - 1);
    fence_regs(o);
    wg_fence();
    issue_pv(n_tiles - 1);
    wg_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty + 8 * ((n_tiles - 1) % kStages));
  }
  float l0 = l[0], l1 = l[1];

  // ---------------------------------------------------------- epilogue --
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float i0 = 1.f / (l0 == 0.f ? 1.f : l0), i1 = 1.f / (l1 == 0.f ? 1.f : l1);
  // stage O (bf16) in this consumer's own q rows, in q's swizzled layout
  uint8_t* const stage = smem + c * 64 * kRowBytes;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    uint8_t* const at = stage + (i / 8) * kHalfBytes + rl * kRowBytes + (((i % 8) ^ g) * 16) + 4 * t;
    *reinterpret_cast<uint32_t*>(at) = pack_bf16(o[4 * i] * i0, o[4 * i + 1] * i0);
    *reinterpret_cast<uint32_t*>(at + 8 * kRowBytes) =
        pack_bf16(o[4 * i + 2] * i1, o[4 * i + 3] * i1);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
  bf16* const out = p.out + ((long long)b * p.Sq * p.H + h) * D;
  const long long oss = (long long)p.H * D;
#pragma unroll
  for (int it = 0; it < D / 16; ++it) {
    const int chunk = tid + 128 * it;        // 64 rows x D / 8 chunks of 16 bytes
    const int r = chunk / Lt::kChunks, c16 = chunk % Lt::kChunks;
    const int row = q0 + 64 * c + r;
    if (row < p.Sq) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          stage + (c16 / 8) * kHalfBytes + r * kRowBytes + (((c16 % 8) ^ (r % 8)) * 16));
      *reinterpret_cast<uint4*>(out + row * oss + c16 * 8) = v;
    }
  }
}

// 4-D map (d, then s, h, b in ascending stride order) over one bf16 view
// of head dim D with unit last stride; boxes of 64 columns x 128 rows of
// s.  ``perm`` receives the order.  Returns the encoder's CUresult (0 on
// success).
int encode_view(CUtensorMap* map, const void* ptr, int D, long long S, long long heads,
                long long B, long long ss, long long sh, long long sb, int (&perm)[3]) {
  EncodeTiledFn fn = encoder();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const long long ext[3] = {S, heads, B}, str[3] = {2 * ss, 2 * sh, 2 * sb};
  int ord[3] = {0, 1, 2};
  // an extent-1 dim's stride is never used: it sorts last
  auto key = [&](int i) { return ext[i] == 1 ? (1ll << 62) : str[i]; };
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (key(ord[j]) < key(ord[i])) {
        const int tmp = ord[i];
        ord[i] = ord[j];
        ord[j] = tmp;
      }
  cuuint64_t dims[4] = {(cuuint64_t)D, 0, 0, 0}, strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1}, estr[4] = {1, 1, 1, 1};
  long long span = 2LL * D;  // bytes up to the previous dim
  for (int i = 0; i < 3; ++i) {
    const int d = ord[i];
    perm[i] = d;
    dims[1 + i] = (cuuint64_t)ext[d];
    const long long st = ext[d] == 1 ? span : str[d];
    strides[i] = (cuuint64_t)st;
    span = st * ext[d];
    if (d == 0) box[1 + i] = kBK;
  }
  return (int)fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                 box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
           int H, int Hkv, int causal, long long qsb, long long qss, long long qsh,
           long long ksb, long long kss, long long ksh, long long vsb, long long vss,
           long long vsh, cudaStream_t st) {
  if (Skv == 0) {  // no key: every row is 0 (l == 0 gives 1)
    cudaMemsetAsync(out, 0, (size_t)B * Sq * H * D * sizeof(bf16), st);
    return static_cast<int>(cudaGetLastError());
  }
  Params p;
  p.out = static_cast<bf16*>(out);
  p.B = B;
  p.Sq = Sq;
  p.Skv = Skv;
  p.H = H;
  p.rep = H / Hkv;
  p.causal = causal;
  p.n_qt = (Sq + kBQ - 1) / kBQ;
  p.scale_log2 = kLog2e / sqrtf((float)D);
  CUtensorMap tq, tk, tv;
  int r = encode_view(&tq, q, D, Sq, H, B, qss, qsh, qsb, p.qperm);
  if (r == 0) r = encode_view(&tk, k, D, Skv, Hkv, B, kss, ksh, ksb, p.kperm);
  if (r == 0) r = encode_view(&tv, v, D, Skv, Hkv, B, vss, vsh, vsb, p.vperm);
  if (r != 0) return -r;
  cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       Layout<D>::kSmemBytes);
  const long long blocks = (long long)p.n_qt * H * B;
  flash_fwd_kernel<D><<<(unsigned)blocks, kThreads, Layout<D>::kSmemBytes, st>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Sq, H, D), k / v (B, Skv, Hkv, D) bf16 with unit last stride and
// the other strides (in elements, multiples of 8) given, D 64 or 128; out
// (B, Sq, H, D) contiguous.  Every row start must be 16-byte aligned (the
// wrapper checks).  Returns cudaGetLastError() after the launch, the
// tensor-map encoder's CUresult negated if a map could not be made, or
// cudaErrorInvalidValue for another D.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int Sq, int Skv, int H, int Hkv, int D,
                                      int causal, long long qsb, long long qss, long long qsh,
                                      long long ksb, long long kss, long long ksh,
                                      long long vsb, long long vss, long long vsh,
                                      void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, out, B, Sq, Skv, H, Hkv, causal, qsb, qss, qsh, ksb, kss,
                        ksh, vsb, vss, vsh, st);
    case 128:
      return launch<128>(q, k, v, out, B, Sq, Skv, H, Hkv, causal, qsb, qss, qsh, ksb, kss,
                         ksh, vsb, vss, vsh, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
