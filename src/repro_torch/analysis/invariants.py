"""The EP wire-contract invariant catalog (DESIGN.md §17).

Each :class:`Rule` states one invariant of the transport protocol that can
be proven *statically* — from command streams, guard tables, session
layouts, and network configs, before any traffic moves.  The catalog is
the shared vocabulary between the verifier
(:mod:`repro_torch.analysis.verify`), its findings, the fuzz harness's
seeded mutants, and the DESIGN.md table; rule ids are stable and never
reused.

Several of these rules reconstruct protocol bugs of earlier designs of
the transport — the catalog exists so the *next* such bug is caught at
plan time, not by a flaky threaded repro.  This is the port's copy of the
reference catalog (``repro.analysis.invariants``); rule ids are shared.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple


class Rule(NamedTuple):
    id: str
    title: str
    statement: str
    caught: str          # which bug class this rule would have caught


@dataclass(frozen=True)
class Finding:
    """One invariant violation: the rule it breaks, a human-readable
    message, and the offending descriptor/config (``where`` is free-form
    structured context — row index, guard id, offsets...)."""

    rule: str
    message: str
    severity: str = "error"
    where: tuple = field(default_factory=tuple)

    def __str__(self) -> str:
        loc = f" @ {self.where}" if self.where else ""
        return f"[{self.rule}] {self.message}{loc}"


_RULES = [
    Rule("EPV-001", "imm-channel-width",
         "Every immediate-carrying command's channel fits the 3-bit imm "
         "channel field (< N_CHANNELS_MAX).",
         "generic width guard (descriptor carries 8 channel bits, the imm "
         "codec only 3 — a wide channel would silently alias mod 8)"),
    Rule("EPV-002", "fence-count-width",
         "Every completion fence's required write count fits the 21-bit "
         "imm count field (<= FENCE_COUNT_MAX).",
         "a 6-bit count field truncated buckets past 63 writes"),
    Rule("EPV-003", "seq-operand-width",
         "Every SEQ_ATOMIC operand (HT chunk id) fits the 16-bit imm "
         "value field (<= IMM_VAL_MAX).",
         "generic width guard for the HT chunk-id pipeline"),
    Rule("EPV-004", "guard-no-overlap",
         "Registered guard ranges are pairwise non-overlapping: a landing "
         "offset resolves to at most one guard (the MR model).",
         "guard extents sized from payload bytes excluded the inline "
         "codec scale blocks — the verifier sees the gap/overlap directly"),
    Rule("EPV-005", "guard-id-unique",
         "Registered guard ids are unique: two buckets sharing an id merge "
         "their write counts and fences fire early.",
         "guards keyed by a 6-bit wire slot, aliasing "
         "expert e onto guard e % 64 past 63 experts/rank"),
    Rule("EPV-006", "guard-covers-write",
         "Every dispatch write's landing range [dst_off, dst_off+len) that "
         "touches a registered guard range is fully contained in ONE range "
         "(no straddling, no partial coverage of inline scales).",
         "fp8/int8 wire tokens carry inline scale blocks; a guard "
         "extent sized from payload-only bytes left each token's tail "
         "outside its bucket"),
    Rule("EPV-007", "fence-count-exact",
         "Each completion fence's required count equals the number of "
         "dispatch writes (same pusher, same destination) resolving to its "
         "guard id; every fence addresses a registered guard.",
         "aliased guards double-counted writes, firing fences before "
         "their bucket had fully landed"),
    Rule("EPV-008", "srd-displacement-bound",
         "coalesce_cap * (reorder_window + 1) <= SEQ_MOD // 4, and "
         "reorder_window < SEQ_MOD // 4: receiver seq unwrap stays "
         "unambiguous under srd reordering.",
         "write coalescing multiplied per-message displacement by "
         "the run length, silently exceeding the unwrap window"),
    Rule("EPV-009", "session-namespace-disjoint",
         "Session slots' memory regions and guard/counter windows are "
         "pairwise disjoint, and adjacent slots' channel windows are "
         "disjoint (two in-flight layers never share a wire seq space).",
         "guards the session layout (per-layer namespacing) against "
         "future geometry changes"),
    Rule("EPV-010", "descriptor-op-known",
         "Every descriptor's op field decodes to a known opcode.",
         "generic decode guard (an unknown op is dropped or misexecuted "
         "depending on consumer path)"),
    Rule("EPV-012", "combine-unguarded",
         "No combine write's landing range intersects a registered guard "
         "range: combine returns must never satisfy a dispatch fence.",
         "the return region overlapping a receive bucket would let "
         "in-flight combines count toward another bucket's fence"),
    # dynamic-analysis and lint rule ids share the catalog so findings from
    # all three analysis parts speak one vocabulary
    Rule("RACE-LOCKSET", "eraser-lockset",
         "Every concurrency-relevant transport field (FifoChannel "
         "counters, Network clock/accounting, Proxy execution state) is "
         "consistently protected by at least one common lock once shared — "
         "modulo the SPSC ring's intentional producer-owned lockless "
         "reads.",
         "guards the threaded-proxy path (racecheck.py, validated by "
         "seeded lock-removal mutants)"),
    Rule("LNT-BITMASK", "no-magic-bitmask",
         "No magic all-ones bit-mask literal in core/transport outside "
         "wire_format.py — every width/mask/shift has one home.",
         "a field resize that misses one stale hand-written mask is the "
         "width-bug class of the count field"),
    Rule("LNT-SCALE-DIV", "no-scale-division",
         "No float division by a constant-like divisor in quantization-"
         "scale math: multiply by a precomputed reciprocal.",
         "XLA constant-folds x / QMAX with different rounding than "
         "eager numpy (1-ULP scale drift between traced and eager paths)"),
    Rule("LNT-ASSERT-PROTO", "no-bare-protocol-assert",
         "No bare assert referencing protocol-width constants in "
         "core/transport: python -O removes asserts.",
         "generic hardening — protocol checks must raise ProtocolError"),
    Rule("LNT-PL-WHEN", "kernel-occupancy-guarded",
         "Pallas kernels taking an occupancy/count ref must gate work "
         "with pl.when.",
         "rows past bucket occupancy hold padding garbage"),
]

CATALOG: dict[str, Rule] = {r.id: r for r in _RULES}
