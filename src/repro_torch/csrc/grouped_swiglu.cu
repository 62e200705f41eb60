// grouped_swiglu: per group g, y = bf16(bf16(silu(x@wg)*(x@wu)) @ wd) with
// the weights of expert g / B; rows at or past cnt[g] are exact zeros.
//
// Replaces the TPU kernel repro/kernels/grouped_matmul.py:179
// grouped_swiglu_pallas (body _swiglu_kernel :154, _swiglu_block :138),
// the LL decode expert compute (ep.py:239 via moe.py:68).
//
// Bound on an H100: LL decode at batch 4 fills 64 rows of (expert, source)
// sub-buckets over about 15 experts, so the call is bound by reading each
// occupied expert's three D x F weight matrices once, ~17.3 MB an expert at
// D = 2048, F = 1408 (memory, 3.35 TB/s).  Design: the two passes of
// swiglu_tiles.cuh over a (G*Cg, F) bf16 scratch h that the wrapper
// allocates.  The G = E * B groups are walked as E experts of B * Cg rows:
// one block tile gathers the occupied prefixes of all B sub-buckets of an
// expert, so the expert's weights stream once, not once per source; tiles
// with no occupied row read no weights.  The TPU's 1 MB VMEM accumulator
// has no place in 227 KB of shared memory, hence the split.
#include "swiglu_tiles.cuh"

using namespace swiglu_tiles;

extern "C" int grouped_swiglu_launch(const void* x, const void* cnt, const void* wg,
                                     const void* wu, const void* wd, void* h, void* y,
                                     int G, int Cg, int B, int D, int F, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int E = B > 0 ? G / B : 0;
  Args up{};
  up.a = static_cast<const bf16*>(x);
  up.a_nrows = G * Cg;
  up.cnt = static_cast<const int*>(cnt);
  up.C = B * Cg;
  up.B = B;
  up.Cg = Cg;
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
