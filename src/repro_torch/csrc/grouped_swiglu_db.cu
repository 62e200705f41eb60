// grouped_swiglu_db: per expert e, y = bf16(bf16(silu(x@wg)*(x@wu)) @ wd)
// over its occupied rows (below cnt[e]), rows past the count exact zeros;
// x (E, C, D), w_gate / w_up (E, D, F), w_down (E, F, D), y (E, C, D) bf16,
// flat (E,) counts only (the wrapper refuses bucketed counts, as the TPU
// kernel asserts at grouped_matmul.py:303).
//
// Replaces the TPU kernel repro/kernels/grouped_matmul.py:269
// grouped_swiglu_db_pallas (body _swiglu_db_kernel :229), which
// ops.grouped_swiglu selects under REPRO_SWIGLU_DB=1 for flat counts: the
// HT expert compute for an expert_fn without .fused (ep.py:359-366).
//
// Bound on an H100: at the HT prefill shape (64 experts, 128 rows each,
// ~4,000 occupied rows, D = 2048, F = 1408) the call reads every expert's
// three D x F matrices once, 1.1 GB: 0.33 ms at 3.35 TB/s, against
// 6 * D * F flops an occupied row (0.07 ms at 989 TF/s): bytes.
//
// Design.  The TPU kernel differs from grouped_swiglu_pallas only in its
// memory schedule: token row blocks stay in HBM and are copied by hand
// through two VMEM slots, the next occupied block in flight while this one
// computes, so that unoccupied blocks cost no reads.  On Hopper that
// schedule is the TMA ring of swiglu_tiles.cuh: a producer warp keeps four
// 48 KB stages of token rows and weight tiles in flight while two consumer
// warpgroups run wgmma on the stages that have landed, and a tile (or a
// consumer's 64 rows) with no occupied row loads nothing.  So this entry
// runs the loop's two passes, as grouped_swiglu.cu does, with one
// sub-bucket an expert (B = 1, Cg = C: flat counts): kUp writes h =
// bf16(silu(gate) * up) (E*C, F) for the occupied rows, kDownStore y = h @
// wd with exact zeros past the count.  Any C: the 3-D TMA map over (E, C,
// K) zero-fills past C, so a ragged row tile never reads the next expert's
// rows.  The reference's fallback to its pipelined kernel for a C without
// a divisor >= 8 (:282-287) is a TPU DMA-size constraint with no
// counterpart here.  D and F must be multiples of 8 (the tensor maps'
// 16-byte strides).
#include "swiglu_tiles.cuh"

using namespace swiglu_tiles;

// x (E, C, D), w_gate / w_up (E, D, F), w_down (E, F, D) bf16, cnt (E,)
// int32, h (E*C, F) bf16 scratch, y (E, C, D) bf16; D, F multiples of 8.
extern "C" int grouped_swiglu_db_launch(const void* x, const void* cnt, const void* wg,
                                        const void* wu, const void* wd, void* h, void* y,
                                        int E, int C, int D, int F, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  Args up{};
  up.a = static_cast<const bf16*>(x);
  up.a_nrows = E * C;
  up.cnt = static_cast<const int*>(cnt);
  up.C = C;
  up.B = 1;
  up.Cg = C;
  up.K = D;
  up.N = F;
  up.out_bf16 = static_cast<bf16*>(h);
  const int err = launch<kUp>(up, E, static_cast<const bf16*>(wg),
                              static_cast<const bf16*>(wu), s);
  if (err != 0) return err;

  Args dn = up;
  dn.a = static_cast<const bf16*>(h);
  dn.K = F;
  dn.N = D;
  dn.out_bf16 = static_cast<bf16*>(y);
  return launch<kDownStore>(dn, E, static_cast<const bf16*>(wd), nullptr, s);
}
