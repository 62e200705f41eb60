// gather_swiglu_scatter: for each occupied slot s of expert e (s below
// cnt[e]), gather row src[s] of x_ext, apply expert e's SwiGLU and add
// w_slot[s] * y into row src[s] of the fp32 output.  One token may own
// several slots; their contributions add.
//
// Replaces the TPU kernel repro/kernels/grouped_matmul.py:368
// gather_swiglu_scatter_pallas (body _gss_kernel :316), the fused HT expert
// compute (ep.py:353-358 via moe.py:71-74).
//
// Bound on an H100: at HT prefill every expert is occupied, so the call
// reads all E experts' weights (3 * D * F * 2 bytes each, 1.1 GB for 64
// experts at D = 2048, F = 1408) against 6 * D * F flops per occupied slot;
// at 1024 prefill tokens the bytes set the bound.  Design: pass (a) of
// swiglu_tiles.cuh gathers token rows through src inside the tile load
// (cp.async from the producer warp into the swizzled tile, since TMA cannot
// gather; no (E, C, D) gather buffer), and pass (b) reads h by TMA and adds
// w_slot * y into the output with fp32 atomicAdd (two columns an atomic)
// straight from its accumulators (no (E*C, D) expert-output buffer).  A
// 128-row tile covers the served capacity, so each expert's weights stream
// once.  The TPU kernel keeps the whole (T+1, D) accumulator in VMEM and so
// gates on its size (ops.py:68,84); the atomics need no such gate and this
// kernel launches at every size.  Atomics add in a different order on
// every run, so results are compared with a tolerance, not bitwise.
#include "swiglu_tiles.cuh"

using namespace swiglu_tiles;

extern "C" int gather_swiglu_scatter_launch(const void* x_ext, const void* src,
                                            const void* w_slot, const void* cnt,
                                            const void* wg, const void* wu, const void* wd,
                                            void* h, void* out, int Tp1, int E, int C, int D,
                                            int F, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  Args up{};
  up.a = static_cast<const bf16*>(x_ext);
  up.a_rows = static_cast<const int*>(src);
  up.a_nrows = Tp1;
  up.cnt = static_cast<const int*>(cnt);
  up.C = C;
  up.B = 1;
  up.Cg = C;
  up.K = D;
  up.N = F;
  up.out_bf16 = static_cast<bf16*>(h);
  const int err = launch<kUp, true>(up, E, static_cast<const bf16*>(wg),
                              static_cast<const bf16*>(wu), s);
  if (err != 0) return err;

  Args dn = up;
  dn.a = static_cast<const bf16*>(h);
  dn.a_rows = nullptr;
  dn.a_nrows = E * C;
  dn.K = F;
  dn.N = D;
  dn.out_bf16 = nullptr;
  dn.out_f32 = static_cast<float*>(out);
  dn.s_rows = static_cast<const int*>(src);
  dn.s_w = static_cast<const float*>(w_slot);
  dn.s_nrows = Tp1;
  return launch<kDownScatter>(dn, E, static_cast<const bf16*>(wd), nullptr, s);
}
