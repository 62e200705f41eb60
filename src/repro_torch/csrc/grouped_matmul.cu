// grouped_matmul: per group g, y[g] = bf16(x[g] @ w[g]) with fp32 sums;
// x (G, M, K), w (G, K, N), y (G, M, N) bf16; rows at or past cnt[g] are
// exact zeros.
//
// Replaces the TPU kernel repro/kernels/grouped_matmul.py:105
// grouped_matmul_pallas (body _gm_kernel :71), the package's public
// grouped GEMM (ops.grouped_matmul, repro/kernels/ops.py:25).
//
// Bound on an H100: each occupied group reads its K x N weights once and
// does 2 * K * N flops a row; at 64 groups of up to 128 occupied rows,
// K = 2048 and N = 1408 (qwen2-moe's x @ w_gate at the HT prefill shape)
// the 369 MB of weights set the bound (0.11 ms at 3.35 TB/s) against
// 2.4e10 flops (0.024 ms at 989 TF/s).  Design: the kDownStore pass of
// swiglu_tiles.cuh is this function exactly: one block per (group, 128-row
// tile, 256-column tile), the weights and rows fed by TMA into a 4-stage
// ring, two consumer warpgroups of 64 rows on wgmma with fp32 accumulators,
// so that a 128-row group reads each weight tile once; a consumer whose
// rows are all past the count issues nothing, unoccupied tiles load nothing
// and store zeros, and TMA's zero fill masks ragged M, N and K (the tensor
// maps' strides must be 16-byte multiples, so the wrapper requires K and N
// to be multiples of 8).
#include "swiglu_tiles.cuh"

using namespace swiglu_tiles;

extern "C" int grouped_matmul_launch(const void* x, const void* cnt, const void* w,
                                     void* y, int G, int M, int K, int N, void* stream) {
  Args a{};
  a.a = static_cast<const bf16*>(x);
  a.a_nrows = G * M;
  a.cnt = static_cast<const int*>(cnt);
  a.C = M;
  a.B = 1;
  a.Cg = M;
  a.K = K;
  a.N = N;
  a.out_bf16 = static_cast<bf16*>(y);
  return launch<kDownStore>(a, G, static_cast<const bf16*>(w), nullptr,
                            reinterpret_cast<cudaStream_t>(stream));
}
