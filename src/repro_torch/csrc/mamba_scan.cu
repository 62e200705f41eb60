// Mamba-1 selective scan, forward and backward, fp32.
//
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t      (per channel d, state n)
//   y_t = C_t . h_t + D * x_t
//
// x, dt, y, dy, dx, ddt: (Bt, S, Di); A, dA: (Di, N); B, C, dB, dC: (Bt, S, N);
// D, dD: (Di,); states: (Bt, ceil(S / kChunk), Di, N), the state before the
// first step of each chunk of kChunk steps.  N must be 16 (d_state of every
// Mamba config in the repository; the wrapper raises on anything else).
//
// Replaces the TPU kernel repro/kernels/mamba_scan.py:53 mamba_scan_pallas
// (body _scan_kernel :24), which keeps a (bd, N) state block resident in VMEM
// across the sequential chunk axis of its grid.  The TPU package has no
// backward kernel (it differentiates the lax.scan oracle); this file adds one.
//
// Bound on an H100, at Bt 4, S 1024, Di 8192.  Forward: bytes.  It reads x
// and dt and writes y (12 bytes per (b, t, d): 403 MB) and, when the caller
// keeps them for the backward (every training call), the chunk states (64
// bytes per (b, d) every kChunk steps: 268 MB), 0.200 ms at 3.35 TB/s, above
// its one exponential per (b, t, d, n) on the special-function units (0.128
// ms: 16 per SM per clock, 132 SMs, 1.98 GHz) and its 7 other fp32
// operations per (b, t, d, n) (0.056 ms at 67 TFLOP/s).  Backward: bytes.
// It reads x, dt, dy and the chunk states and writes dx and ddt (0.281 ms),
// above its two exponentials (0.257 ms; the kernel below computes each once,
// 0.128 ms) and 26 fp32 operations (0.208 ms) per (b, t, d, n).
//
// Design.  Hopper blocks run in no order, so the sequential grid axis of the
// TPU kernel becomes a loop over time inside a thread, and a channel's 16
// states are spread over 4 lanes so that enough warps are in flight to hide
// the loads: Bt x Di x 4 threads (131,072 at the shapes above, ~31 warps an
// SM, one wave).
//
// The forward: a warp takes 8 channels, each lane one channel and 4 of its
// states, 256-thread blocks (64 channels).  Each chunk of kChunk steps the
// block stages x and dt (interleaved, so a step reads both in one 8-byte
// load) and the B_t and C_t rows (shared by all its channels) in shared
// memory by cp.async, three chunks ahead of the one it computes.  A step is
// one ex2.approx of dt * a * log2(e) per state (one special-function op; the
// backward recomputes the same decay the same way) and 3 FMAs.  The lane's
// partial sums of y_t (its 4 states' C . h) stay in registers for the chunk
// and are summed over the channel's 4 lanes by a 6-shuffle transpose-reduce
// at its end, which leaves each lane 2 steps of y to write.  At each chunk
// boundary a lane writes its 4 states as one 16-byte store, so a channel's
// 64 bytes and a warp's 512 are contiguous.
//
// The backward sweeps time in reverse per (batch, channel), carrying
// g = dL/dh_t.  A warp takes 8 channels and their 16 states, each lane 2
// channels x 2 states (four 128-thread blocks an SM, 32 channels a block:
// small blocks, so that one block's barrier and chunk end overlap the
// others' work).  Each chunk it recomputes the chunk's states from the
// saved boundary state, in registers, keeping each step's decay exp(dt a)
// for the reverse walk, so one exponential per (b, t, d, n): ex2.approx of
// dt * a * log2(e), one special-function op.  The chunk's x, dt, dy (8-byte
// channel pairs where Di is even), B, C and boundary states land in shared
// memory by cp.async, the next chunk's while this one computes, x and dt
// (and B and C) interleaved so that a step reads them in one 16-byte load.
// dB_t and dC_t sum a lane's 2 channels in registers and its quad's 8 (the
// quad's lanes hold the same states) by a 3-shuffle transpose-reduce a
// step.  dx and ddt sum a channel's 16 states over the 8 lanes that hold
// them: each lane leaves its per-step partial sums in shared memory, and at
// the chunk's end each half-warp adds one step's for all 32 channels (8
// independent 16-byte loads a lane, not a chain of shuffles every step),
// writes dx and ddt, adds dD's terms, and sums dB_t, dC_t over the block's
// 4 warps; one float4 atomicAdd per (b, t, 4 values) and block adds those
// across the Di / 32 blocks.  dA sums over batch and time in registers and
// adds across the Bt blocks with atomicAdd.  Atomics add in any order, so
// dA, dB, dC and dD can change in the last bits from run to run.  On an
// H100 the backward runs at about 44% of the bytes bound, limited by the
// rate it issues instructions at (PERF.md).
#include <cuda_runtime.h>

namespace {

constexpr int kN = 16;        // d_state
constexpr int kChunk = 8;     // steps per chunk (the Python wrapper's SCAN_CHUNK)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int bytes, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(ok ? 16 : 0) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(ok ? 8 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// One stage of a transpose-reduce over the lanes that differ in bit M:
// lanes with bit M set keep the upper W of their 2W live values and
// receive the partner's upper half.
template <int W, int M, int L>
__device__ __forceinline__ void transpose_reduce_stage(float (&v)[L], int lane) {
  static_assert(2 * W <= L, "live values");
  const bool upper = (lane & M) != 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float send = upper ? v[j] : v[j + W];
    const float keep = upper ? v[j + W] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// -------------------------------------------------------------- forward --
// lane (gid, q) = (lane / 4, lane % 4) holds channel gid of its warp's 8
// and states 4 q .. 4 q + 3
constexpr int kFwdThreads = 256;
constexpr int kFwdChannels = kFwdThreads / 4;   // channels a block
constexpr int kFwdStages = 4;                   // chunks in shared memory
static_assert(kFwdThreads == 4 * kFwdChannels && kN == 16, "4 lanes, 4 states a lane");
static_assert(kChunk * kFwdChannels == 2 * kFwdThreads, "a thread stages 2 steps of x, dt");
static_assert(kChunk * 2 * kN / 4 <= kFwdThreads, "a thread stages at most one B or C piece");

// one chunk's inputs (zeros past S and Di)
struct FwdStage {
  float2 xdt[kChunk][kFwdChannels];             // a channel's x, dt
  float4 bc[kChunk][2][kN / 4];                 // B_t, then C_t, 4 states a float4
};

__global__ void __launch_bounds__(kFwdThreads, 4)
scan_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ Dp,
                float* __restrict__ y, float* __restrict__ states, int S, int Di, int NC) {
  __shared__ FwdStage sm[kFwdStages];
  const int tid = threadIdx.x, lane = tid & 31, q = lane & 3;
  const int ch = (tid >> 5) * 8 + (lane >> 2);           // the lane's channel in the block
  const int b = blockIdx.y, d0 = blockIdx.x * kFwdChannels, d = d0 + ch;
  const bool d_ok = d < Di;
  const long long row = (long long)b * S;
  // staging: x and dt of channel io_ch at steps io_i and io_i + kChunk / 2;
  // threads below kChunk * 8 one 16-byte piece of B_t or C_t
  const int io_ch = tid % kFwdChannels, io_i = tid / kFwdChannels;
  const bool io_ok = d0 + io_ch < Di;
  const long long io_off = (row + io_i) * Di + d0 + io_ch;
  const int bc_i = tid / 8, bc_w = tid / 4 % 2, bc_q = tid % 4;
  const float* bc_src = (bc_w ? Cm : Bm) + (row + bc_i) * kN + bc_q * 4;

  auto stage = [&](int c) {
    FwdStage& st = sm[c % kFwdStages];
    const int t0 = c * kChunk;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = io_i + r * (kChunk / 2);
      const bool ok = io_ok && t0 + i < S;
      const long long o = ok ? io_off + (long long)(t0 + r * (kChunk / 2)) * Di : 0;
      cp_async(&st.xdt[i][io_ch].x, x + o, 4, ok);
      cp_async(&st.xdt[i][io_ch].y, dt + o, 4, ok);
    }
    if (tid < kChunk * 8) {
      const bool ok = t0 + bc_i < S;
      cp_async(&st.bc[bc_i][bc_w][bc_q], ok ? bc_src + t0 * kN : Bm, 16, ok);
    }
  };

  float a2[4], h[4];
  {
    const float4 a = d_ok ? *reinterpret_cast<const float4*>(A + (size_t)d * kN + 4 * q)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    a2[0] = a.x * kLog2e, a2[1] = a.y * kLog2e, a2[2] = a.z * kLog2e, a2[3] = a.w * kLog2e;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = 0.f;
  const float Dd = d_ok ? Dp[d] : 0.f;
  float* y_out = y + row * Di + d;
  float4* st_out = states == nullptr ? nullptr
      : reinterpret_cast<float4*>(states + ((long long)b * NC * Di + d) * kN + 4 * q);

#pragma unroll
  for (int c = 0; c < kFwdStages - 1; ++c) {
    if (c < NC) stage(c);
    cp_async_commit();
  }
  for (int c = 0; c < NC; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kFwdStages - 2) : "memory");
    // chunk c has landed, and every thread is done with chunk c - 1's
    // buffer, which the stage below overwrites
    __syncthreads();
    if (c + kFwdStages - 1 < NC) stage(c + kFwdStages - 1);
    cp_async_commit();
    const FwdStage& st = sm[c % kFwdStages];
    const int t0 = c * kChunk;
    if (st_out != nullptr && d_ok)
      st_out[(long long)c * Di * (kN / 4)] = make_float4(h[0], h[1], h[2], h[3]);
    // acc[i]: the lane's 4 states' share of y at step i; steps past S have
    // dt = x = 0: exp(0) = 1 and no input, h unchanged
    float acc[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const float2 xd = st.xdt[i][ch];
      const float4 bv = st.bc[i][0][q], cv = st.bc[i][1][q];
      const float dtx = xd.y * xd.x;
      const float bn[4] = {bv.x, bv.y, bv.z, bv.w}, cn[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        h[k] = fmaf(ex2(xd.y * a2[k]), h[k], dtx * bn[k]);
        acc[i] = k == 0 ? h[k] * cn[k] : fmaf(h[k], cn[k], acc[i]);
      }
    }
    // sum over the channel's 4 lanes: lane q keeps steps 2 q and 2 q + 1
    transpose_reduce_stage<4, 2>(acc, lane);
    transpose_reduce_stage<2, 1>(acc, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = 2 * q + j;
      if (d_ok && t0 + i < S)
        y_out[(long long)(t0 + i) * Di] = fmaf(st.xdt[i][ch].x, Dd, acc[j]);
    }
  }
}

// ------------------------------------------------------------- backward --
// A warp takes 8 channels and all 16 states: lane (gid, tig) = (lane / 4,
// lane % 4) holds channels 2 tig, 2 tig + 1 and states 2 gid, 2 gid + 1,
// indexed [j][s] below (channel j, state s of the lane's two).
constexpr int kBwdThreads = 128;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdChannels = kBwdWarps * 8;     // channels a block
// at the chunk's end warp w takes steps w and w + 4: a half-warp each, a
// lane the block's 16 channel pairs for dx and ddt, and 8 float4s of
// dB_t, dC_t in 2 parts
static_assert(2 * kBwdWarps == kChunk && kBwdChannels == 32, "chunk-end layout");
static_assert(2 * kChunk * kN / 2 == kBwdThreads, "a thread stages one B or C pair a chunk");
constexpr int kDxtPad = 4;   // float4s after each warp's row of dxt

// a block's shared memory: the double-buffered chunk inputs (zeros past S
// and Di, staged by cp.async) and the per-step sums the chunk's end adds
struct BwdSmem {
  struct Stage {
    float4 xdt[kChunk][kBwdChannels / 2];       // a channel pair's x, x, dt, dt
    float dy[kChunk][kBwdChannels];
    float4 bc[kChunk][kN / 2];                  // a state pair's B, B, C, C
    float h0[kBwdChannels][kN];                 // the chunk's first state
  } stage[2];
  float red[kBwdWarps][kChunk][2 * kN];         // a warp's dB_t, dC_t sums
  // a lane's (sum g B, sum gdh a) for its 2 channels, by step; padded so
  // that the chunk end's reads of the warps' lanes hit distinct banks
  float4 dxt[kChunk][kBwdWarps * (32 + kDxtPad)];
};
static_assert(sizeof(BwdSmem) <= 48 * 1024, "static shared memory");

// kPairs: Di is even, so x, dt and dy are staged in 8-byte channel pairs
template <bool kPairs>
__global__ void __launch_bounds__(kBwdThreads, 4)
scan_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ Dp,
                const float* __restrict__ states, const float* __restrict__ dy,
                float* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dA,
                float* __restrict__ dB, float* __restrict__ dC, float* __restrict__ dD,
                int S, int Di, int NC) {
  __shared__ BwdSmem sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int c0 = warp * 8 + 2 * tig, n0 = 2 * gid;   // the lane's first channel, state
  const int b = blockIdx.y, d0 = blockIdx.x * kBwdChannels;
  const long long row = (long long)b * S;
  // The B, C and state pointers below are taken at t = 0 and moved each
  // chunk; the x, dt, dy and dx, ddt offsets are formed each chunk, which
  // holds fewer registers across the loop.  Staging x, dt, dy: kPairs,
  // channels io_ch, io_ch + 1 at step io_i; else channel io_ch at steps
  // io_i, io_i + 4.
  const int io_ch = kPairs ? 2 * (tid % (kBwdChannels / 2)) : tid % kBwdChannels;
  const int io_i = kPairs ? tid / (kBwdChannels / 2) : tid / kBwdChannels;
  const bool io_ok = d0 + io_ch < Di;
  // B and C in 8-byte state pairs; the chunk's first states in 16-byte
  // pieces
  const int bc_i = tid / (kN / 2) % kChunk, bc_q = tid % (kN / 2);
  const float* bc_src = (tid < kChunk * kN / 2 ? Bm : Cm) + (row + bc_i) * kN + bc_q * 2;
  const int h_ch = tid / (kN / 4), h_q = tid % (kN / 4);
  const bool h_ok = d0 + h_ch < Di;
  const float* h_src = states + ((long long)b * NC * Di + d0 + h_ch) * kN + h_q * 4;
  // the chunk end: step e_i; channels e_ch, e_ch + 1 (dx, ddt, dD)
  const int e_i = warp + kBwdWarps * (lane / 16), e_ch = 2 * (lane % 16);

  const int e_src = lane % 16 / 4 * (32 + kDxtPad) + lane % 4;   // + 4 gid: the lanes holding them
  float e_D[2], e_gD[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2; ++j) e_D[j] = d0 + e_ch + j < Di ? Dp[d0 + e_ch + j] : 0.f;

  auto stage = [&](int c) {
    BwdSmem::Stage& st = sm.stage[c & 1];
    const int t0 = c * kChunk;
    const long long tD = (long long)t0 * Di;
    constexpr int kRows = kPairs ? 1 : kBwdThreads / kBwdChannels;  // steps apart
#pragma unroll
    for (int r = 0; r < (kPairs ? 1 : kChunk / kRows); ++r) {
      const int i = io_i + r * kRows;
      const bool ok = io_ok && t0 + i < S;
      const long long o = ok ? (row + t0 + i) * Di + d0 + io_ch : 0;
      float* const xdt = &st.xdt[i][io_ch / 2].x + io_ch % 2;
      cp_async(xdt, x + o, kPairs ? 8 : 4, ok);
      cp_async(xdt + 2, dt + o, kPairs ? 8 : 4, ok);
      cp_async(&st.dy[i][io_ch], dy + o, kPairs ? 8 : 4, ok);
    }
    {
      const bool ok = t0 + bc_i < S;
      cp_async(&st.bc[bc_i][bc_q].x + 2 * (tid / (kChunk * kN / 2)),
               ok ? bc_src + t0 * kN : Bm, 8, ok);
    }
    // c * Di * kN = 2 t0 Di: the chunk's states
    cp_async(&st.h0[h_ch][h_q * 4], h_ok ? h_src + 2 * tD : states, 16, h_ok);
    cp_async_commit();
  };

  float a[2][2], a2[2][2], g[2][2], gA[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const bool ok = d0 + c0 + j < Di;
    const float2 a_ = ok ? *reinterpret_cast<const float2*>(A + (size_t)(d0 + c0 + j) * kN + n0)
                         : make_float2(0.f, 0.f);
    a[j][0] = a_.x, a[j][1] = a_.y;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      a2[j][s] = a[j][s] * kLog2e;
      g[j][s] = 0.f;
      gA[j][s] = 0.f;
    }
  }
  // the slot of the value this lane holds after the transpose-reduce:
  // dB_t (tig 0, 1) or dC_t (tig 2, 3) of state n0 + tig % 2
  const int red = (tig >> 1) * kN + n0 + (tig & 1);

  stage(NC - 1);
  for (int c = NC - 1; c >= 0; --c) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // chunk c has landed, and every thread is done with chunk c + 1's
    // buffers, which the next stage and this chunk's sums overwrite
    __syncthreads();
    if (c > 0) stage(c - 1);   // lands while this chunk computes
    const BwdSmem::Stage& st = sm.stage[c & 1];
    const int t0 = c * kChunk;

    // recompute the chunk forward from its saved state: hs[i] is the state
    // before step i, das[i] its decay exp(dt_i a)
    float hs[kChunk + 1][2][2], das[kChunk][2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 h = *reinterpret_cast<const float2*>(&st.h0[c0 + j][n0]);
      hs[0][j][0] = h.x, hs[0][j][1] = h.y;
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const float4 xd = st.xdt[i][c0 / 2];
      const float2 bv = *reinterpret_cast<const float2*>(&st.bc[i][gid]);
      const float dvs[2] = {xd.z, xd.w}, dtx[2] = {xd.z * xd.x, xd.w * xd.y};
      const float bn[2] = {bv.x, bv.y};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          das[i][j][s] = ex2(dvs[j] * a2[j][s]);
          hs[i + 1][j][s] = fmaf(das[i][j][s], hs[i][j][s], dtx[j] * bn[s]);
        }
    }
    // reverse sweep: g = dL/dh_t.  A step's sums go to shared memory after
    // the next step's loads (p_dxt, p_red), so no store sits between a
    // step's loads and the previous step's arithmetic
    float4 p_dxt;
    float p_red;
#pragma unroll
    for (int i = kChunk - 1; i >= 0; --i) {
      const float4 xd = st.xdt[i][c0 / 2], bc = st.bc[i][gid];
      const float2 yv = *reinterpret_cast<const float2*>(&st.dy[i][c0]);
      if (i < kChunk - 1) {
        sm.dxt[i + 1][tid + kDxtPad * warp] = p_dxt;
        sm.red[warp][i + 1][red] = p_red;
      }
      const float xs[2] = {xd.x, xd.y}, dvs[2] = {xd.z, xd.w}, dys[2] = {yv.x, yv.y};
      const float bn[2] = {bc.x, bc.y}, cn[2] = {bc.z, bc.w};
      // v: the dB_t and dC_t terms of the lane's 2 states, summed over its
      // 2 channels; gb, gh: per channel, sum_n g B_n and
      // sum_n (dL/dexp(dt a_n)) exp(dt a_n) a_n over its 2 states
      float v[4], gb[2], gh[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float dtx = dvs[j] * xs[j];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const float vc = dys[j] * hs[i + 1][j][s];             // dy_t * h_t
          v[2 + s] = j == 0 ? vc : v[2 + s] + vc;
          g[j][s] = fmaf(dys[j], cn[s], g[j][s]);                 // dL/dh_t
          gb[j] = s == 0 ? g[j][s] * bn[s] : fmaf(g[j][s], bn[s], gb[j]);
          v[s] = j == 0 ? g[j][s] * dtx : fmaf(g[j][s], dtx, v[s]);
          g[j][s] *= das[i][j][s];                                // dL/dh_{t-1}
          const float gdh = g[j][s] * hs[i][j][s];
          gh[j] = s == 0 ? gdh * a[j][s] : fmaf(gdh, a[j][s], gh[j]);
          gA[j][s] = fmaf(gdh, dvs[j], gA[j][s]);
        }
      }
      p_dxt = make_float4(gb[0], gh[0], gb[1], gh[1]);
      // dB_t, dC_t over the warp's 8 channels: the lane's 2, then its quad
      transpose_reduce_stage<2, 2>(v, lane);
      transpose_reduce_stage<1, 1>(v, lane);
      p_red = v[0];
    }
    sm.dxt[0][tid + kDxtPad * warp] = p_dxt;
    sm.red[warp][0][red] = p_red;
    __syncthreads();
    // dx and ddt of step e_i: a channel pair's 16 states summed over its 8
    // lanes; dD's terms alongside
    {
      float4 u = sm.dxt[e_i][e_src];
#pragma unroll
      for (int k = 1; k < 8; ++k) u = add4(u, sm.dxt[e_i][e_src + 4 * k]);
      const float gb[2] = {u.x, u.z}, gh[2] = {u.y, u.w};
      const float4 xd = st.xdt[e_i][e_ch / 2];
      const float2 yv = *reinterpret_cast<const float2*>(&st.dy[e_i][e_ch]);
      const float xs[2] = {xd.x, xd.y}, dvs[2] = {xd.z, xd.w}, dys[2] = {yv.x, yv.y};
      const bool t_ok = t0 + e_i < S;
      const long long e_off = (row + t0 + e_i) * Di + d0 + e_ch;
      float* const px = dx + e_off;
      float* const pt = ddt + e_off;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        e_gD[j] = fmaf(dys[j], xs[j], e_gD[j]);
        if (t_ok && d0 + e_ch + j < Di) {
          px[j] = fmaf(dvs[j], gb[j], dys[j] * e_D[j]);
          pt[j] = fmaf(xs[j], gb[j], gh[j]);
        }
      }
    }
    // dB_t and dC_t of step e_i: the block's 4 warps summed (lane: float4
    // lane % 8, warps part and part + 2, then the 2 parts by a shuffle),
    // one float4 atomic per 4 values adds across the Di / kBwdChannels
    // blocks
    {
      const int j4 = lane % 8, part = lane / 8 % 2;
      float4 s4 = add4(reinterpret_cast<const float4*>(sm.red[part][e_i])[j4],
                       reinterpret_cast<const float4*>(sm.red[part + 2][e_i])[j4]);
      s4 = add4(s4, make_float4(__shfl_xor_sync(0xffffffffu, s4.x, 8),
                                __shfl_xor_sync(0xffffffffu, s4.y, 8),
                                __shfl_xor_sync(0xffffffffu, s4.z, 8),
                                __shfl_xor_sync(0xffffffffu, s4.w, 8)));
      if (part == 0 && t0 + e_i < S)
        atomicAdd(reinterpret_cast<float4*>((j4 < kN / 4 ? dB : dC) + (row + t0 + e_i) * kN +
                                            (j4 % (kN / 4)) * 4), s4);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (d0 + c0 + j < Di)
      atomicAdd(reinterpret_cast<float2*>(dA + (size_t)(d0 + c0 + j) * kN + n0),
                make_float2(gA[j][0], gA[j][1]));
    if (d0 + e_ch + j < Di) atomicAdd(dD + d0 + e_ch + j, e_gD[j]);
  }
}

}  // namespace

extern "C" int mamba_scan_fwd_launch(const void* x, const void* dt, const void* A, const void* B,
                                     const void* C, const void* D, void* y, void* states,
                                     int Bt, int S, int Di, void* stream) {
  const int NC = (S + kChunk - 1) / kChunk;
  const dim3 grid((Di + kFwdChannels - 1) / kFwdChannels, Bt);
  scan_fwd_kernel<<<grid, kFwdThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<const float*>(C), static_cast<const float*>(D),
      static_cast<float*>(y), static_cast<float*>(states), S, Di, NC);
  return static_cast<int>(cudaGetLastError());
}

// dA, dB, dC and dD are accumulated with atomicAdd: the caller zeroes them.
extern "C" int mamba_scan_bwd_launch(const void* x, const void* dt, const void* A, const void* B,
                                     const void* C, const void* D, const void* states,
                                     const void* dy, void* dx, void* ddt, void* dA, void* dB,
                                     void* dC, void* dD, int Bt, int S, int Di, void* stream) {
  auto kernel = Di % 2 == 0 ? scan_bwd_kernel<true> : scan_bwd_kernel<false>;
  const int NC = (S + kChunk - 1) / kChunk;
  const dim3 grid((Di + kBwdChannels - 1) / kBwdChannels, Bt);
  kernel<<<grid, kBwdThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<const float*>(C), static_cast<const float*>(D),
      static_cast<const float*>(states), static_cast<const float*>(dy), static_cast<float*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dA), static_cast<float*>(dB),
      static_cast<float*>(dC), static_cast<float*>(dD), S, Di, NC);
  return static_cast<int>(cudaGetLastError());
}
