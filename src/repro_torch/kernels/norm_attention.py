"""RMSNorm, causal flash attention and flash decoding: the port of
``repro.kernels.rmsnorm`` (``rmsnorm_pallas``),
``repro.kernels.flash_attention`` (``flash_attention_pallas``) and both
kernels of ``repro.kernels.decode_attention`` (``decode_attention_pallas``
over a contiguous cache, ``decode_attention_paged`` through block tables).

Each kernel has a plain PyTorch version here (``*_plain``: what the CPU
path runs and what the CUDA kernel is held against on the card) and a
wrapper (``*_cuda``) that checks its inputs, allocates the output and
scratch, and launches the hand-written kernel of ``csrc/rmsnorm.cu``,
``csrc/flash_attention.cu``, ``csrc/decode_attention.cu`` or
``csrc/decode_attention_paged.cu`` on the current stream.  The wrappers take bf16 activations (RMSNorm with an fp32 scale,
the dtype ``cast_params`` keeps norm scales in) and head dim 128, and
raise on anything else; each counts its launches in ``.launches``.

The plain attention versions follow the TPU kernels' arithmetic rather
than a softmax: fp32 scores, ``m_safe`` for rows with no live key, the
unnormalised ``P`` rounded to ``v.dtype`` before the PV product while the
sum takes it in fp32, ``l == 0 -> 1``, one division at the end
(:func:`partial_softmax`, whose step the training path's blocked attention
in ``models.layers`` shares, with its PV product in v's dtype).  Nothing
here has a backward kernel: the serving path calls these under
``torch.inference_mode()``, and training keeps to ``models.layers``.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.grouped_matmul import _check_cuda

Tensor = torch.Tensor

HEAD_DIM = 128       # the head dim the attention kernels are written for
DECODE_STEP = 32     # positions a decode_attention block takes a step
PAGED_CHUNK = 256    # cache positions a decode_attention_paged block takes
DECODE_REPS = (1, 2, 4, 8)   # query heads a kv head may serve (H / Hkv)
# RMSNorm's launch shapes, in vectors of 8 values (4 where D % 8 != 0):
RMSNORM_ROWS_MAX_VECTORS = 32  # widest row the several-rows-a-block kernel takes
RMSNORM_ROW_MAX_THREADS = 512  # the one-row-a-block kernel's largest block


# ================================================================ RMSNorm ==
def rmsnorm_plain(x: Tensor, scale: Tensor, eps: float = 1e-5) -> Tensor:
    """x (..., D); scale (D,) fp32: ``x * rsqrt(mean(x^2) + eps) * scale``
    reduced in fp32 and rounded once to ``x.dtype``."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def rmsnorm_vectors(D: int) -> int:
    """The vectors a row of width D is cut in: 8 values each, 4 where
    D % 8 != 0."""
    return D // (8 if D % 8 == 0 else 4)


@functools.lru_cache(maxsize=None)
def rmsnorm_threads_per_row(rows: int, D: int, sms: int) -> int:
    """Threads a row gets in ``csrc/rmsnorm.cu``, from the shape and the
    card's ``sms``.  Rows of at most ``RMSNORM_ROWS_MAX_VECTORS`` vectors
    (the q/k norms) go to the rows kernel, several rows a block: from 4
    lanes a row, doubling while a lane would hold more than 4 vectors, or
    while all the rows together would give the card fewer than 256 threads
    an SM, and each lane still has a vector.  Wider rows get one block a
    row, 2 vectors a thread (1 where there are fewer rows than SMs), up to
    ``RMSNORM_ROW_MAX_THREADS``.  The C entries refuse a shape their kernel
    cannot take, not one this rule would not pick."""
    vecs = rmsnorm_vectors(D)
    if vecs <= RMSNORM_ROWS_MAX_VECTORS:
        t = 4
        while t < 32 and t < vecs and (-(-vecs // t) > 4
                                       or rows * t < sms * 256):
            t *= 2
        return t
    per = 1 if rows < sms else 2
    return min(RMSNORM_ROW_MAX_THREADS, -(-vecs // (32 * per)) * 32)


def rmsnorm_cuda(x: Tensor, scale: Tensor, eps: float = 1e-5) -> Tensor:
    """CUDA kernel for :func:`rmsnorm_plain`: bf16 x, fp32 scale."""
    name = "rmsnorm"
    D = x.shape[-1]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: x must be bfloat16, got {x.dtype}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (D,):
        raise ValueError(f"{name}: scale must be float32 of shape ({D},), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if D % 4:
        raise ValueError(f"{name}: the row width {D} must be a multiple of 4")
    _check_cuda(name, x=x, scale=scale)
    if scale.device != x.device:
        raise ValueError(f"{name}: scale on {scale.device}, x on {x.device}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = build.library()
    rows = x.numel() // D
    sms = _sm_count(x.device)
    threads = rmsnorm_threads_per_row(rows, D, sms)
    args = (x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D, eps,
            threads)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if rmsnorm_vectors(D) <= RMSNORM_ROWS_MAX_VECTORS:
            err = lib.rmsnorm_rows_launch(*args, sms, stream)
        else:
            err = lib.rmsnorm_row_launch(*args, stream)
    build.check(err, name)
    rmsnorm_cuda.launches += 1
    return out


rmsnorm_cuda.launches = 0


# ============================================================== attention ==
def partial_softmax(s: Tensor, v: Tensor, spec: str,
                    pv_dtype: torch.dtype = torch.float32
                    ) -> tuple[Tensor, Tensor, Tensor]:
    """One block of attention the TPU kernels' way, from fp32 scores ``s``
    (-inf where masked, keys last) and ``v``: the unnormalised output
    (fp32), the row max (-inf for a row with no live key) and the sum.  P
    is rounded to ``v.dtype`` before the PV product (the einsum ``spec``,
    taken in ``pv_dtype``) while the sum takes it in fp32."""
    m = s.amax(dim=-1)
    # fully-masked rows have m = -inf; exp(s - m) would be NaN
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp(s - m_safe[..., None])
    o = torch.einsum(spec, p.to(v.dtype).to(pv_dtype), v.to(pv_dtype))
    return o.to(torch.float32), m, p.sum(dim=-1)


def _normalise(o: Tensor, l: Tensor) -> Tensor:
    return o / torch.where(l == 0.0, 1.0, l)[..., None]


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, *,
                          causal: bool = True) -> Tensor:
    """q (B, Sq, H, D); k/v (B, Skv, Hkv, D), H % Hkv == 0 (q head h reads
    kv head h // (H // Hkv)) -> (B, Sq, H, D) in q.dtype.  The causal mask
    is top-left aligned: query i sees keys 0..i."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, D).to(torch.float32)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.to(torch.float32)) * (
        1.0 / math.sqrt(D))
    if causal:
        qpos = torch.arange(Sq, device=q.device)
        kpos = torch.arange(Skv, device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, float("-inf"))
    o, _, l = partial_softmax(s, v, "bgrqk,bkgd->bgrqd")
    return _normalise(o, l).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def _check_attention(name: str, q: Tensor, k: Tensor, v: Tensor,
                     q_dims: int) -> None:
    if q.dim() != q_dims or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    H, D, Hkv = q.shape[-2], q.shape[-1], k.shape[2]
    if q.shape[0] != k.shape[0] or k.shape[3] != D:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)}")
    if D != HEAD_DIM:
        raise ValueError(f"{name}: the CUDA kernel takes head dim {HEAD_DIM}, "
                         f"got {D}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{name}: {H} heads do not share {Hkv} kv heads")
    for n, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {n} must be bfloat16, got {t.dtype}")
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: {n} is on {t.device}, not on q's "
                             "CUDA device")
        if (t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1])
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: {n} needs unit last stride, row "
                             "starts 16-byte aligned")


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, *,
                         causal: bool = True) -> Tensor:
    """CUDA kernel for :func:`flash_attention_plain` (bf16, head dim 128;
    q, k and v may be strided views with a unit last stride)."""
    name = "flash_attention"
    _check_attention(name, q, k, v, 4)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, Hkv, int(causal), *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], stream)
    build.check(err, name)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


# ========================================================== flash decoding ==
def decode_attention_plain(q: Tensor, k: Tensor, v: Tensor, pos, *,
                           start: int = 0) -> Tensor:
    """q (B, H, D) one query per sequence; k/v (B, S, Hkv, D) a cache slice
    holding global positions [start, start + S); positions start..pos are
    live, ``pos`` an int or a 0-d integer tensor.  GQA as
    :func:`flash_attention_plain`.  Returns (B, H, D) in q.dtype, 0 for a
    sequence with no live position."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, D).to(torch.float32)
    s = torch.einsum("bgrd,bsgd->bgrs", qg, k.to(torch.float32)) * (
        1.0 / math.sqrt(D))
    kpos = start + torch.arange(S, device=q.device)
    s = torch.where(kpos <= pos, s, float("-inf"))
    o, _, l = partial_softmax(s, v, "bgrs,bsgd->bgrd")
    return _normalise(o, l).reshape(B, H, D).to(q.dtype)


@functools.lru_cache(maxsize=None)
def decode_chunk(B: int, S: int, Hkv: int, sms: int, per_sm: int) -> int:
    """Cache positions a ``decode_attention`` block takes, in whole steps
    of ``DECODE_STEP``.  Of the cuts whose ``B * Hkv * ceil(S / chunk)``
    blocks fit the card's resident slots (``sms`` SMs of ``per_sm``
    blocks) at once, and, where the shapes allow it, give every SM two
    blocks (each keeps its next two steps in flight), the one whose
    busiest SM streams the fewest positions, ``ceil(blocks / sms) *
    chunk``; ties go to the smaller chunk.  The shapes and the card alone
    fix it, never ``pos``."""
    pairs = max(1, B * Hkv)
    cuts = []
    for ns in range(1, max(1, sms * per_sm // pairs) + 1):
        per = -(-S // ns)                      # ceil(S / ns), then steps
        chunk = max(1, -(-per // DECODE_STEP)) * DECODE_STEP
        blocks = pairs * -(-S // chunk)
        cuts.append((blocks >= min(per_sm, 2) * sms,
                     -(-blocks // sms) * chunk, chunk))
    filled = [c for c in cuts if c[0]] or cuts
    return min(c[1:] for c in filled)[1]


_sms: dict = {}             # device index -> SMs
_decode_slots: dict = {}    # (device index, rep) -> (SMs, blocks an SM)
_arrivals: dict = {}        # device index -> the arrival counters in use


def _index(device: torch.device) -> int:
    return (device.index if device.index is not None
            else torch.cuda.current_device())


def _sm_count(device: torch.device) -> int:
    """The SMs of ``device``."""
    key = _index(device)
    if key not in _sms:
        _sms[key] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sms[key]


def _decode_slots_of(lib, device: torch.device, rep: int) -> tuple:
    """(SMs, resident ``decode_attention`` blocks an SM holds at ``rep``)."""
    key = (_index(device), rep)
    if key not in _decode_slots:
        per_sm = lib.decode_attention_blocks_per_sm(rep)
        if per_sm <= 0:
            raise RuntimeError(f"decode_attention: no occupancy for rep {rep}")
        _decode_slots[key] = (_sm_count(device), per_sm)
    return _decode_slots[key]


def _arrival_counters(device: torch.device, n: int) -> Tensor:
    """``n`` int32 arrival counters on ``device``, zero between launches:
    each launch's merging blocks set theirs back to 0, so one buffer serves
    every launch on the stream, and a captured graph's replays, with no
    memset.  A larger request allocates anew, and the smaller buffers stay
    alive, since a captured graph may still hold their address."""
    held = _arrivals.setdefault(_index(device), [])
    if not held or held[-1].numel() < n:
        held.append(torch.zeros(max(n, 256), dtype=torch.int32,
                                device=device))
    return held[-1]


def decode_attention_cuda(q: Tensor, k: Tensor, v: Tensor, pos: Tensor, *,
                          start: int = 0) -> Tensor:
    """CUDA kernel for :func:`decode_attention_plain` (bf16, head dim 128,
    contiguous q and cache, H / Hkv in ``DECODE_REPS``), in one launch.
    ``pos`` is a 0-d int32 tensor on q's device, which the kernel reads
    there: the grid and the scratch follow the shapes alone, so a CUDA
    graph can capture the call and replay it at any position."""
    name = "decode_attention"
    _check_attention(name, q, k, v, 3)
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    if rep not in DECODE_REPS:
        raise ValueError(f"{name}: {rep} query heads a kv head; the "
                         f"kernel takes {DECODE_REPS}")
    _check_cuda(name, q=q, k=k, v=v)
    if not isinstance(pos, Tensor):
        raise ValueError(f"{name}: pos must be a 0-d int32 tensor on "
                         f"{q.device}, got {type(pos).__name__}")
    if pos.dim() != 0 or pos.dtype != torch.int32 or pos.device != q.device:
        raise ValueError(f"{name}: pos must be a 0-d int32 tensor on "
                         f"{q.device}, got {pos.dtype} {tuple(pos.shape)} "
                         f"on {pos.device}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.library()
    chunk = decode_chunk(B, S, Hkv, *_decode_slots_of(lib, q.device, rep))
    ns = max(1, -(-S // chunk))
    part_o = torch.empty((B, H, ns, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((2, B, H, ns), dtype=torch.float32, device=q.device)
    arrivals = _arrival_counters(q.device, B * Hkv)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            part_o.data_ptr(), part_ml.data_ptr(), arrivals.data_ptr(),
            out.data_ptr(), B, S, H, Hkv, int(start), ns, chunk, stream)
    build.check(err, name)
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0


# ================================================ paged flash decoding ====
def _paged_live(block_tables: Tensor, pos: Tensor, n_blocks: int,
                bs: int) -> tuple[Tensor, Tensor]:
    """(block ids with the unallocated clamped to 0 (B, nb), live positions
    (B, nb * bs)): a position is live when its table entry names a pool
    block (-1, or any id outside [0, n_blocks), is unallocated) and it is
    at most the sequence's ``pos``."""
    bt = block_tables.to(torch.int64)
    alloc = (bt >= 0) & (bt < n_blocks)
    kpos = torch.arange(bt.shape[1] * bs, device=bt.device)
    live = (alloc.repeat_interleave(bs, dim=1)
            & (kpos[None, :] <= pos.to(torch.int64)[:, None]))
    return torch.where(alloc, bt, 0), live


def decode_attention_paged_plain(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                                 block_tables: Tensor, pos: Tensor) -> Tensor:
    """q (B, H, D) one query per sequence; k_pool / v_pool (NB, bs, Hkv, D)
    block pools; block_tables (B, nb) pool block ids (-1 unallocated); pos
    (B,) the newest position of each sequence.  Sequence b attends the
    positions p <= pos[b] whose block ``block_tables[b, p // bs]`` is
    allocated, at row p % bs of that block; GQA as
    :func:`flash_attention_plain`.  Unallocated blocks are skipped, as the
    TPU kernel skips them (decode_attention.py:119), not read as block 0,
    as its oracle reads them (:213).  Returns (B, H, D) in q.dtype, 0 for a
    sequence with no live position."""
    B, H, D = q.shape
    NB, bs, Hkv = k_pool.shape[:3]
    nb = block_tables.shape[1]
    idx, live = _paged_live(block_tables, torch.as_tensor(pos,
                            device=q.device), NB, bs)
    kc = k_pool[idx].reshape(B, nb * bs, Hkv, D)
    # dead rows may hold anything, NaN included: they add exact zeros
    vc = torch.where(live[:, :, None, None], v_pool[idx].reshape(
        B, nb * bs, Hkv, D), torch.zeros((), dtype=v_pool.dtype,
                                         device=q.device))
    qg = q.reshape(B, Hkv, H // Hkv, D).to(torch.float32)
    s = torch.einsum("bgrd,bsgd->bgrs", qg, kc.to(torch.float32)) * (
        1.0 / math.sqrt(D))
    s = torch.where(live[:, None, None, :], s, float("-inf"))
    o, _, l = partial_softmax(s, vc, "bgrs,bsgd->bgrd")
    return _normalise(o, l).reshape(B, H, D).to(q.dtype)


def decode_attention_paged_cuda(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                                block_tables: Tensor, pos: Tensor) -> Tensor:
    """CUDA kernels for :func:`decode_attention_paged_plain` (bf16, head
    dim 128, contiguous q and pools, int32 tables and ``pos`` on the card,
    H / Hkv in ``DECODE_REPS``).  ``pos`` stays on the device, so every
    chunk of table columns launches and finds its live positions itself."""
    name = "decode_attention_paged"
    if (q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape
            or k_pool.shape[3] != q.shape[2]):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, pools k "
                         f"{tuple(k_pool.shape)}, v {tuple(v_pool.shape)}")
    B, H, D = q.shape
    NB, bs, Hkv, _ = k_pool.shape
    if D != HEAD_DIM:
        raise ValueError(f"{name}: the CUDA kernel takes head dim {HEAD_DIM}, "
                         f"got {D}")
    if Hkv == 0 or H % Hkv or H // Hkv not in DECODE_REPS:
        raise ValueError(f"{name}: {H} heads over {Hkv} kv heads; the "
                         f"kernel takes {DECODE_REPS} query heads a kv head")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"{name}: block tables {tuple(block_tables.shape)} "
                         f"for {B} sequences")
    for k, t in (("block_tables", block_tables), ("pos", pos)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: {k} must be int32, got {t.dtype}")
    if tuple(pos.shape) != (B,):
        raise ValueError(f"{name}: pos {tuple(pos.shape)} for {B} sequences")
    for k, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {k} must be bfloat16, got {t.dtype}")
    _check_cuda(name, q=q, k_pool=k_pool, v_pool=v_pool,
                block_tables=block_tables, pos=pos)
    if any(t.device != q.device for t in (k_pool, v_pool, block_tables, pos)):
        raise ValueError(f"{name}: inputs on more than one device")
    nb = block_tables.shape[1]
    cols = max(1, PAGED_CHUNK // bs)     # table columns a block takes
    ns = max(1, -(-nb // cols))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    part_o = torch.empty((B, H, ns, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((2, B, H, ns), dtype=torch.float32, device=q.device)
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_paged_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), pos.data_ptr(), part_o.data_ptr(),
            part_ml[0].data_ptr(), part_ml[1].data_ptr(), out.data_ptr(),
            B, H, Hkv, NB, bs, nb, cols, ns, stream)
    build.check(err, name)
    decode_attention_paged_cuda.launches += 1
    return out


decode_attention_paged_cuda.launches = 0
