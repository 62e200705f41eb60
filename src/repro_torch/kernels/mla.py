"""Absorbed multi-head latent attention decoding: one query a head and a
sequence over the latent cache (``models/mla.py``).  The JAX package has
no MLA, so this replaces no TPU kernel; it is the decode step's attention
at Moonlight-16B-A3B's widths.

q (B, H, Dk) holds each head's absorbed query (q_nope . W_uk, then its
RoPE part), the cache (B, S_max, Dk) one row a position ([c, k_pe]);
head h's score at position j is q[b, h] . cache[b, j] over all Dk
columns, its value the row's first ``v_dim`` columns (the latent c).  Out
(B, H, v_dim): the softmax over positions 0..pos, ``pos`` a 0-d int32 on
the device; 0 where none is live.

:func:`mla_decode_plain` is the plain version (the CPU path, and what
the kernel is held against on the card), with the decoders' arithmetic
(``norm_attention.partial_softmax``: fp32 scores, P rounded to the cache's
dtype before the PV product, the sum in fp32).  :func:`mla_decode_cuda`
launches ``csrc/mla_decode.cu`` (bf16, H 16, Dk 576, v_dim 512) on a grid
that the shapes and the card alone fix (:func:`mla_chunk`), so a CUDA
graph captures the call once and replays it at any position.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.grouped_matmul import _check_cuda
from repro_torch.kernels.norm_attention import (_arrival_counters,
                                                _normalise, _sm_count,
                                                partial_softmax)

Tensor = torch.Tensor

# the shapes the kernel is written for: 16 heads (mma.sync's M), a
# 576-wide row (512 latent + 64 RoPE), the value the first 512
MLA_HEADS, MLA_DK, MLA_DV = 16, 576, 512
MLA_TILE = 64          # positions a block takes a step


def mla_decode_plain(q: Tensor, cache: Tensor, pos, *, scale: float,
                     v_dim: int) -> Tensor:
    """q (B, H, Dk), cache (B, S, Dk), positions 0..pos live (an int or a
    0-d integer tensor) -> (B, H, v_dim) in q.dtype."""
    S = cache.shape[1]
    s = torch.einsum("bhk,bsk->bhs", q.to(torch.float32),
                     cache.to(torch.float32)) * scale
    live = torch.arange(S, device=q.device) <= pos
    s = torch.where(live, s, float("-inf"))
    o, _, l = partial_softmax(s, cache[..., :v_dim], "bhs,bsv->bhv")
    return _normalise(o, l).to(q.dtype)


@functools.lru_cache(maxsize=None)
def mla_chunk(B: int, S: int, sms: int) -> int:
    """Positions a block takes, in whole tiles of ``MLA_TILE``: one block a
    sequence where the batch fills the card's SMs (one block an SM, the
    kernel's shared memory), else the sequence cut into ``sms // B``
    chunks, so that every SM streams a share.  Never ``pos``."""
    ns = max(1, sms // max(1, B))
    per = -(-S // ns)
    return max(1, -(-per // MLA_TILE)) * MLA_TILE


def mla_decode_cuda(q: Tensor, cache: Tensor, pos: Tensor, *, scale: float,
                    v_dim: int) -> Tensor:
    """CUDA kernel for :func:`mla_decode_plain`: bf16, H 16, Dk 576, v_dim
    512, contiguous q and cache, ``pos`` a 0-d int32 tensor on q's device
    (read there), one launch."""
    name = "mla_decode"
    if q.dim() != 3 or cache.dim() != 3 or q.shape[0] != cache.shape[0]:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, cache "
                         f"{tuple(cache.shape)}")
    B, H, Dk = q.shape
    S = cache.shape[1]
    if (H, Dk, cache.shape[2], v_dim) != (MLA_HEADS, MLA_DK, MLA_DK,
                                          MLA_DV):
        raise ValueError(f"{name}: the kernel takes {MLA_HEADS} heads, rows "
                         f"of {MLA_DK} and values of {MLA_DV}; got q "
                         f"{tuple(q.shape)}, cache {tuple(cache.shape)}, "
                         f"v_dim {v_dim}")
    for n, t in (("q", q), ("cache", cache)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {n} must be bfloat16, got {t.dtype}")
    _check_cuda(name, q=q, cache=cache)
    if cache.device != q.device:
        raise ValueError(f"{name}: cache on {cache.device}, q on {q.device}")
    if (not isinstance(pos, Tensor) or pos.dim() != 0
            or pos.dtype != torch.int32 or pos.device != q.device):
        raise ValueError(f"{name}: pos must be a 0-d int32 tensor on "
                         f"{q.device}")
    out = torch.empty((B, H, v_dim), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or S == 0:
        return out.zero_()
    lib = build.library()
    chunk = mla_chunk(B, S, _sm_count(q.device))
    ns = -(-S // chunk)
    # the partials and the arrival counters, used when ns > 1
    part_o = torch.empty((B, H, ns, v_dim) if ns > 1 else (1,),
                         dtype=torch.float32, device=q.device)
    part_ml = torch.empty((2, B, H, ns) if ns > 1 else (1,),
                          dtype=torch.float32, device=q.device)
    arrivals = _arrival_counters(q.device, B)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mla_decode_launch(
            q.data_ptr(), cache.data_ptr(), pos.data_ptr(), part_o.data_ptr(),
            part_ml.data_ptr(), arrivals.data_ptr(), out.data_ptr(), B, S,
            ns, chunk, scale * math.log2(math.e), stream)
    build.check(err, name)
    mla_decode_cuda.launches += 1
    return out


mla_decode_cuda.launches = 0
