// decode_attention_paged: flash decoding of one query per sequence
// through a paged KV cache, in one launch.  q (B, H, D) bf16; k / v pools
// (NB, bs, Hkv, D) bf16, D 64 or 128; tables (B, nb) int32 pool block ids (-1,
// or any id outside [0, NB), unallocated); pos (B,) int32 on the device.
// Sequence b attends the positions p <= pos[b] whose block tables[b, p /
// bs] is allocated, at row p % bs of that block; q head h reads kv head
// h / (H / Hkv).  out (B, H, D) bf16, normalised, 0 where nothing is live.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:149
// decode_attention_paged (body _dec_paged_kernel :101), the package's
// paged decoding entry point (ops.decode_attention_paged here), whose
// tables repro_torch.serving.kv_cache.KVBlockPool makes.  Like that
// kernel (:119) and unlike its oracle (:213, which reads -1 as block 0),
// unallocated blocks are skipped.
//
// The kernel is decode_common.cuh's, the contiguous decoder's: one launch
// on a grid (ns, Hkv, B) that neither pos nor the tables change, so a CUDA
// graph captures it once and replays it at new positions and tables;
// 16-byte lanes, a cp.async ring; the last block of a (sequence, kv head)
// merges.  Here is only the map from a position to its pool row,
// TableRows.  A chunk is whole table columns (the wrapper's paged_chunk),
// at most kMaxCols of them; a block whose chunk holds a position <= pos[b]
// stages its columns of tables[b] in shared memory once, an id outside
// [0, NB) as -1, and position j's row is then
// ((tab[j / bs] * bs + j % bs) * Hkv + kh) * D.  A position past pos[b], or
// in an unallocated block, is copied with src-size 0 and so never read:
// no unread row of the pools (the card tests fill them with NaN) reaches
// the arithmetic.
//
// Bound on an H100: each live K and V row is read once, 2 D bytes a row
// each (256 at D = 128): at qwen3-4b's decode shape (B 4, 8 kv heads, ragged
// pos 2078 / 2047 / 1031 / 17) 21.2 MB, 6.3 us at 3.35 TB/s.
#include "decode_common.cuh"

namespace {

constexpr int kMaxCols = 256;  // table columns a chunk holds, at most

template <int D>
struct TableRows {
  const bf16* kb;
  const bf16* vb;
  const int* tab;  // the chunk's columns of tables[b], -1 unallocated
  long long row;   // elements between pool rows
  int j0, bs;

  static __device__ __forceinline__ int n_live(const Params& p, int b) {
    return min(max(__ldg(p.pos + b) + 1, 0), p.S);
  }

  __device__ __forceinline__ TableRows(const Params& p, int b, int kh, int gl, int j0_)
      : row((long long)p.Hkv * D), j0(j0_), bs(p.bs) {
    __shared__ int cols[kMaxCols];
    const int c0 = j0 / bs, n = p.chunk / bs;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int c = c0 + i;
      const int id = c < p.nb ? __ldg(p.tables + (long long)b * p.nb + c) : -1;
      cols[i] = (id >= 0 && id < p.NB) ? id : -1;
    }
    __syncthreads();
    tab = cols;
    kb = p.k + kh * D + 8 * gl;
    vb = p.v + kh * D + 8 * gl;
  }

  // the bits the step's copies returned (recomputing them would read the
  // table again)
  template <int U>
  __device__ __forceinline__ unsigned live(int, int, unsigned ring) const { return ring; }

  // j - j0 < chunk: a chunk is whole steps (kChunkAlign)
  template <int U>
  __device__ __forceinline__ unsigned at(int j, int j1, long long (&off)[U]) const {
    int c = (j - j0) / bs, r = j - j0 - c * bs;
    unsigned live = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int blk = tab[c];
      live |= static_cast<unsigned>(j + u < j1 && blk >= 0) << u;
      // a dead position of an allocated block still names its row, which
      // its copy's src-size 0 leaves unread
      off[u] = ((long long)max(blk, 0) * bs + r) * row;
      if (++r == bs) {
        r = 0;
        ++c;
      }
    }
    return live;
  }
};

}  // namespace

// Resident blocks an SM holds of the kernel for rep query heads a kv head
// at head dim D (0 for a rep or D it does not take, or on error).
extern "C" int decode_attention_paged_blocks_per_sm(int rep, int D) {
  return blocks_per_sm<TableRows>(rep, D);
}

// q (B, H, D), pools (NB, bs, Hkv, D) bf16, tables (B, nb) and pos (B,)
// int32, all contiguous on the device; ns chunks of chunk positions cover
// the nb * bs a sequence may hold (ns * chunk >= nb * bs, ns >= 1), chunk
// a multiple of bs and of 32, at most 256 table columns; part_o (B, H, ns,
// D) and part_ml (2, B, H, ns) the wrapper's fp32 scratch; arrivals (B *
// Hkv) int32, zero, and zero again after the launch; out (B, H, D) bf16.
// D must be 64 or 128, H / Hkv 1, 2, 4, 6 or 8.
extern "C" int decode_attention_paged_launch(const void* q, const void* k, const void* v,
                                             const void* tables, const void* pos, void* part_o,
                                             void* part_ml, void* arrivals, void* out, int B,
                                             int H, int Hkv, int D, int NB, int bs, int nb,
                                             int ns, int chunk, void* stream) {
  if (bs < 1 || ns < 1 || chunk < 1 || chunk % bs || chunk % kChunkAlign ||
      chunk / bs > kMaxCols || (long long)ns * chunk < (long long)nb * bs)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.pos = static_cast<const int*>(pos);
  p.tables = static_cast<const int*>(tables);
  p.part_o = static_cast<float*>(part_o);
  p.part_m = static_cast<float*>(part_ml);
  p.part_l = p.part_m + (long long)B * H * ns;
  p.arrivals = static_cast<int*>(arrivals);
  p.out = static_cast<bf16*>(out);
  p.H = H;
  p.Hkv = Hkv;
  p.ns = ns;
  p.chunk = chunk;
  p.S = nb * bs;
  p.NB = NB;
  p.bs = bs;
  p.nb = nb;
  p.scale_log2 = kLog2e / sqrtf((float)D);
  return launch<TableRows>(p, B, D, reinterpret_cast<cudaStream_t>(stream));
}
