"""Single source of truth for the wire contract's bit layouts.

Two packed formats live on the (emulated) wire:

1. The 128-bit **TransferCmd descriptor** (4 x uint32) that rides the
   CPU-GPU FIFO — word 0 carries op/dst_rank/channel/flags, words 1-2 the
   32-bit symmetric-memory offsets, word 3 length+value.

2. The 32-bit **immediate** delivered with an RDMA write/atomic — a
   per-kind layout: seq-carrying kinds are kind(2)|channel(3)|seq(11)|
   value(16); FENCE_ATOMIC is kind(2)|channel(3)|count(21)|unused(6).

Every mask/shift below is derived from a named width so a future field
resize (e.g. widening seq) propagates to the codecs, the receiver
semantics, the srd displacement bound, and the static verifier in
``repro_torch.analysis`` — none of which may re-hardcode a literal;
everything else in ``core/transport`` imports from here.  The port of
``repro.core.transport.wire_format``, constant for constant.

This module imports nothing from the package (it is the bottom of the
transport dependency graph) so anything — codecs, simulator, analysis —
can import it without cycles.
"""
from __future__ import annotations


def _mask(bits: int) -> int:
    return (1 << bits) - 1


class ProtocolError(ValueError):
    """A wire-contract invariant does not hold.

    Raised (never ``assert``-ed: the contract must survive ``python -O``)
    by the transport hot paths and by ``repro_torch.analysis.verify``'s
    ``verify_or_raise``.  Subclasses ``ValueError`` so callers that guard
    config plumbing generically keep working.
    """


# --------------------------------------------------------------------------
# 128-bit TransferCmd descriptor (4 x uint32)
#
#   w0: op(4) | dst_rank(12) | channel(8) | flags(8)
#   w1: src_off(32)
#   w2: dst_off(32)
#   w3: length(20) | value(12)
# --------------------------------------------------------------------------
OP_BITS = 4
RANK_BITS = 12
CH_BITS = 8
FLAGS_BITS = 8

LEN_BITS = 20
VALUE_BITS = 12
OFF_BITS = 32

OP_SHIFT = 0
RANK_SHIFT = OP_SHIFT + OP_BITS            # 4
CH_SHIFT = RANK_SHIFT + RANK_BITS          # 16
FLAGS_SHIFT = CH_SHIFT + CH_BITS           # 24
LEN_SHIFT = 0
VALUE_SHIFT = LEN_SHIFT + LEN_BITS         # 20

OP_MASK = _mask(OP_BITS)                   # 0xF
RANK_MASK = _mask(RANK_BITS)               # 0xFFF
CH_MASK = _mask(CH_BITS)                   # 0xFF
FLAGS_MASK = _mask(FLAGS_BITS)             # 0xFF
LEN_MASK = _mask(LEN_BITS)                 # 0xFFFFF
VALUE_MASK = _mask(VALUE_BITS)             # 0xFFF
MASK32 = _mask(OFF_BITS)                   # 0xFFFFFFFF

# descriptor flags (w0 bits 24..31)
FLAG_FENCE = 0x1   # atomic uses LL completion-fence semantics (else HT seq)

# --------------------------------------------------------------------------
# 32-bit per-kind immediate
#
#   seq-carrying kinds:  kind(2) | channel(3) | seq(11) | value(16)
#   FENCE_ATOMIC:        kind(2) | channel(3) | count(21) | unused(6)
# --------------------------------------------------------------------------
IMM_KIND_BITS = 2
IMM_CH_BITS = 3
IMM_SEQ_BITS = 11
IMM_VALUE_BITS = 16
IMM_COUNT_BITS = 21

IMM_KIND_SHIFT = 0
IMM_CH_SHIFT = IMM_KIND_SHIFT + IMM_KIND_BITS    # 2
IMM_SEQ_SHIFT = IMM_CH_SHIFT + IMM_CH_BITS       # 5
IMM_VALUE_SHIFT = IMM_SEQ_SHIFT + IMM_SEQ_BITS   # 16
IMM_COUNT_SHIFT = IMM_CH_SHIFT + IMM_CH_BITS     # 5 (count overlays seq+value)

IMM_KIND_MASK = _mask(IMM_KIND_BITS)             # 0x3
IMM_CH_MASK = _mask(IMM_CH_BITS)                 # 0x7
IMM_SEQ_MASK = _mask(IMM_SEQ_BITS)               # 0x7FF
IMM_VALUE_MASK = _mask(IMM_VALUE_BITS)           # 0xFFFF
IMM_COUNT_MASK = _mask(IMM_COUNT_BITS)           # 0x1FFFFF

# Derived protocol constants (the names the rest of the tree imports).
N_CHANNELS_MAX = 1 << IMM_CH_BITS                # 8
SEQ_MOD = 1 << IMM_SEQ_BITS                      # 2048
IMM_VAL_MAX = IMM_VALUE_MASK                     # 65535
FENCE_COUNT_MAX = IMM_COUNT_MASK                 # 2097151

# Receiver-side seq unwrap (semantics._unwrap) recovers the full counter
# from an 11-bit wire seq only while |displacement| stays under a quarter
# wrap; srd reordering plus write coalescing must respect this bound.
SRD_DISPLACEMENT_BOUND = SEQ_MOD // 4            # 512

# Layout sanity — plain raises so they also hold under ``python -O``.
if OP_BITS + RANK_BITS + CH_BITS + FLAGS_BITS != 32:
    raise AssertionError("descriptor word 0 fields must pack to 32 bits")
if LEN_BITS + VALUE_BITS != 32:
    raise AssertionError("descriptor word 3 fields must pack to 32 bits")
if IMM_KIND_BITS + IMM_CH_BITS + IMM_SEQ_BITS + IMM_VALUE_BITS != 32:
    raise AssertionError("seq-carrying immediate fields must pack to 32 bits")
if IMM_KIND_BITS + IMM_CH_BITS + IMM_COUNT_BITS > 32:
    raise AssertionError("fence immediate fields must fit in 32 bits")
