"""Static protocol verifier: prove the invariant catalog over command
streams, guard tables, session layouts, and network configs — without
executing anything (DESIGN.md §17).

The verifier consumes the same packed ``(N, 4)`` descriptor batches the
proxy drains and the same ``(bases, extents, guard_ids)`` tables the world
registers, decodes them with the shared codecs, and checks every rule in
:mod:`repro_torch.analysis.invariants` with vectorized passes.  ``EPWorld``
calls :func:`verify_or_raise` at stream-build time (every run, both
session and one-shot), and the fuzz harness calls :func:`verify` directly
— both on the clean generator output (zero findings expected) and on
seeded invariant-breaking mutants (the specific rule id expected).

``CommandStreams`` is duck-typed (any object with ``writes`` /
``write_pusher`` / ``fences`` / ``fence_pusher`` / ``combines`` /
``guard_table`` attributes) so this module never imports ``ep_executor``
— the executor imports *us*.  The port of ``repro.analysis.verify``:
the same rule ids for the same streams.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.analysis.invariants import Finding
from repro_torch.core.transport.fifo import FLAG_FENCE, Op, unpack_cmds
from repro_torch.core.transport.wire_format import (FENCE_COUNT_MAX,
                                                    IMM_VAL_MAX,
                                                    N_CHANNELS_MAX,
                                                    SRD_DISPLACEMENT_BOUND,
                                                    ProtocolError)

# opcodes the proxy consumer actually executes (BARRIER is a reserved
# opcode with no consumer path — a stream carrying it is malformed)
_EXECUTABLE_OPS = frozenset((int(Op.WRITE), int(Op.ATOMIC), int(Op.DRAIN),
                             int(Op.WRITE_ATOMIC)))


# ------------------------------------------------------------------------
# stream-level width/op checks (EPV-001/002/003/010)
# ------------------------------------------------------------------------
def verify_stream(words: np.ndarray, *, n_channels: Optional[int] = None,
                  label: str = "stream") -> list[Finding]:
    """Check one packed (N, 4) descriptor batch: known opcodes and every
    immediate field within its wire width."""
    findings: list[Finding] = []
    words = np.asarray(words)
    if words.size == 0:
        return findings
    cols = unpack_cmds(words.reshape(-1, 4))
    op, ch, src_off, flags = cols.op, cols.channel, cols.src_off, cols.flags

    known = np.isin(op, list(_EXECUTABLE_OPS))
    for r in np.flatnonzero(~known)[:8].tolist():
        findings.append(Finding(
            "EPV-010", f"{label}[{r}]: op {int(op[r])} has no consumer path",
            where=(label, r, int(op[r]))))

    is_w = (op == Op.WRITE) | (op == Op.WRITE_ATOMIC)
    is_at = op == Op.ATOMIC
    sends_imm = is_w | is_at
    ch_max = N_CHANNELS_MAX if n_channels is None \
        else min(n_channels, N_CHANNELS_MAX)
    bad_ch = sends_imm & (ch >= ch_max)
    for r in np.flatnonzero(bad_ch)[:8].tolist():
        findings.append(Finding(
            "EPV-001", f"{label}[{r}]: channel {int(ch[r])} >= {ch_max} "
            "(3-bit imm channel field)", where=(label, r, int(ch[r]))))

    # fences (standalone fenced atomics and piggybacked WRITE_ATOMICs)
    # carry their required write count in the 32-bit src_off operand; the
    # imm codec packs only 21 of those bits
    is_fence = ((op == Op.ATOMIC) & ((flags & FLAG_FENCE) != 0)) \
        | (op == Op.WRITE_ATOMIC)
    bad_cnt = is_fence & (src_off > FENCE_COUNT_MAX)
    for r in np.flatnonzero(bad_cnt)[:8].tolist():
        findings.append(Finding(
            "EPV-002", f"{label}[{r}]: fence count {int(src_off[r])} > "
            f"{FENCE_COUNT_MAX} (21-bit imm count field)",
            where=(label, r, int(src_off[r]))))

    is_sat = is_at & ((flags & FLAG_FENCE) == 0)
    bad_val = is_sat & (src_off > IMM_VAL_MAX)
    for r in np.flatnonzero(bad_val)[:8].tolist():
        findings.append(Finding(
            "EPV-003", f"{label}[{r}]: atomic operand {int(src_off[r])} > "
            f"{IMM_VAL_MAX} (16-bit imm value field)",
            where=(label, r, int(src_off[r]))))
    return findings


# ------------------------------------------------------------------------
# guard-table checks (EPV-004/005)
# ------------------------------------------------------------------------
def _table_arrays(guard_table):
    bases, extents, gids = guard_table
    bases = np.asarray(bases, np.int64).reshape(-1)
    extents = np.asarray(extents, np.int64)
    gids = np.asarray(gids, np.int64)
    extents = np.broadcast_to(extents, bases.shape).reshape(-1)
    gids = np.broadcast_to(gids, bases.shape).reshape(-1)
    return bases, extents, gids


def verify_guard_table(guard_table) -> list[Finding]:
    """Ranges non-overlapping with positive extents (EPV-004), guard ids
    unique (EPV-005) — tolerates malformed tables (unlike
    ``GuardTable.register``, which raises) so mutants are *reported*."""
    findings: list[Finding] = []
    bases, extents, gids = _table_arrays(guard_table)
    if bases.size == 0:
        return findings
    for r in np.flatnonzero(extents <= 0)[:8].tolist():
        findings.append(Finding(
            "EPV-004", f"guard range [{int(bases[r])}, ...) has non-positive "
            f"extent {int(extents[r])}", where=(int(bases[r]),)))
    order = np.argsort(bases, kind="stable")
    b, e = bases[order], bases[order] + np.maximum(extents[order], 0)
    olap = np.flatnonzero(e[:-1] > b[1:])
    for r in olap[:8].tolist():
        findings.append(Finding(
            "EPV-004", f"guard range [{int(b[r])}, {int(e[r])}) overlaps "
            f"[{int(b[r + 1])}, {int(e[r + 1])})",
            where=(int(b[r]), int(b[r + 1]))))
    uniq, cnt = np.unique(gids, return_counts=True)
    for g in uniq[cnt > 1][:8].tolist():
        findings.append(Finding(
            "EPV-005", f"guard id {int(g)} registered "
            f"{int(cnt[uniq == g][0])} times: buckets sharing an id merge "
            "their write counts and fences fire early", where=(int(g),)))
    return findings


def _resolve(offs: np.ndarray, bases, ends, gids) -> np.ndarray:
    """Vectorized landing-offset -> guard-id resolution over a *sorted*
    table; -1 for unregistered memory.  Local (not GuardTable.resolve_batch)
    so malformed tables can still be analyzed."""
    i = np.searchsorted(bases, offs, side="right") - 1
    j = np.maximum(i, 0)
    ok = (i >= 0) & (offs < ends[j])
    return np.where(ok, gids[j], -1)


# ------------------------------------------------------------------------
# cross-stream checks (EPV-006/007/012)
# ------------------------------------------------------------------------
def verify_command_streams(cs, *, net_cfg=None,
                           n_channels: Optional[int] = None,
                           label: str = "cs") -> list[Finding]:
    """Full static check of one LL round's ``CommandStreams``: per-stream
    widths, guard-table shape, guard coverage of every dispatch write,
    exact fence counts, and combine-unguarded — plus the net-config
    displacement bound when ``net_cfg`` is given."""
    findings = []
    findings += verify_stream(cs.writes, n_channels=n_channels,
                              label=f"{label}.writes")
    findings += verify_stream(cs.fences, n_channels=n_channels,
                              label=f"{label}.fences")
    findings += verify_stream(cs.combines, n_channels=n_channels,
                              label=f"{label}.combines")
    findings += verify_guard_table(cs.guard_table)
    if net_cfg is not None:
        findings += verify_net_config(net_cfg)

    bases, extents, gids = _table_arrays(cs.guard_table)
    order = np.argsort(bases, kind="stable")
    sb, se, sg = bases[order], (bases + extents)[order], gids[order]

    # EPV-006: every dispatch write range fully inside one guard range, or
    # fully outside all of them (straddling in corrupts fence counting)
    w = np.asarray(cs.writes).reshape(-1, 4)
    if w.size and sb.size:
        wc = unpack_cmds(w)
        lo, hi = wc.dst_off, wc.dst_off + wc.length
        i = np.searchsorted(sb, lo, side="right") - 1
        j = np.maximum(i, 0)
        inside = (i >= 0) & (lo < se[j])
        contained = inside & (hi <= se[j])
        # rows starting outside any range must not run into the next one
        nxt = np.searchsorted(sb, lo, side="left")
        creeps = ~inside & (nxt < len(sb)) & (hi > sb[np.minimum(nxt,
                                                                 len(sb) - 1)])
        bad = (inside & ~contained) | creeps
        for r in np.flatnonzero(bad)[:8].tolist():
            findings.append(Finding(
                "EPV-006", f"{label}.writes[{r}]: landing range "
                f"[{int(lo[r])}, {int(hi[r])}) is not fully contained in "
                "one registered guard range (inline scales outside the "
                "bucket?)", where=(label, r, int(lo[r]), int(hi[r]))))
        # per-(pusher, dst, gid) write totals for EPV-007, vectorized:
        # pusher/dst are 12-bit ranks and gid is a 32-bit wide id, so the
        # triple packs into one int64 key for a single np.unique pass
        wgid = np.where(contained, sg[j], -1)
        pusher = np.asarray(cs.write_pusher, np.int64).reshape(-1)
        keep = wgid >= 0
        if keep.any():
            key = ((pusher[keep] * 4096 + wc.dst_rank[keep]) << 32) \
                | wgid[keep]
            wuk, wucnt = np.unique(key, return_counts=True)
        else:
            wuk = wucnt = np.zeros(0, np.int64)
    else:
        wuk = wucnt = np.zeros(0, np.int64)

    # EPV-007: each fence's required count == matching write total
    # (vectorized: one sorted-key lookup for the whole fence stream)
    f = np.asarray(cs.fences).reshape(-1, 4)
    if f.size:
        fc = unpack_cmds(f)
        fpush = np.asarray(cs.fence_pusher, np.int64).reshape(-1)
        proper = (fc.op == int(Op.ATOMIC)) & ((fc.flags & FLAG_FENCE) != 0)
        is_reg = np.isin(fc.dst_off, gids) if gids.size else \
            np.zeros(len(f), bool)
        for r in np.flatnonzero(proper & ~is_reg)[:8].tolist():
            findings.append(Finding(
                "EPV-007", f"{label}.fences[{r}]: fence addresses "
                f"unregistered guard id {int(fc.dst_off[r])}",
                where=(label, r, int(fc.dst_off[r]))))
        rows = np.flatnonzero(proper & is_reg)
        if rows.size:
            fkey = ((fpush[rows] * 4096 + fc.dst_rank[rows]) << 32) \
                | fc.dst_off[rows]
            if wuk.size:
                idx = np.clip(np.searchsorted(wuk, fkey), 0, len(wuk) - 1)
                have = np.where(wuk[idx] == fkey, wucnt[idx], 0)
            else:
                have = np.zeros(len(rows), np.int64)
            need = fc.src_off[rows]
            for k in np.flatnonzero(have != need)[:8].tolist():
                r = int(rows[k])
                findings.append(Finding(
                    "EPV-007", f"{label}.fences[{r}]: fence on guard "
                    f"{int(fc.dst_off[r])} requires {int(need[k])} writes "
                    f"but {int(have[k])} resolve to it (pusher "
                    f"{int(fpush[r])} -> rank {int(fc.dst_rank[r])})",
                    where=(label, r, int(fc.dst_off[r]))))

    # EPV-012: combine writes must land entirely in unregistered memory
    c = np.asarray(cs.combines).reshape(-1, 4)
    if c.size and len(sb):
        cc = unpack_cmds(c)
        lo, hi = cc.dst_off, cc.dst_off + cc.length
        i = np.searchsorted(sb, lo, side="right") - 1
        j = np.maximum(i, 0)
        inside = (i >= 0) & (lo < se[j])
        nxt = np.searchsorted(sb, lo, side="left")
        creeps = (nxt < len(sb)) & (hi > sb[np.minimum(nxt, len(sb) - 1)])
        bad = inside | (~inside & creeps)
        for r in np.flatnonzero(bad)[:8].tolist():
            findings.append(Finding(
                "EPV-012", f"{label}.combines[{r}]: combine landing range "
                f"[{int(lo[r])}, {int(hi[r])}) intersects a registered "
                "guard range — combines must never satisfy a dispatch "
                "fence", where=(label, r, int(lo[r]))))
    return findings


# ------------------------------------------------------------------------
# net-config check (EPV-008)
# ------------------------------------------------------------------------
def verify_net_config(net_cfg) -> list[Finding]:
    """srd seq-displacement bound: the receiver unwraps 11-bit wire seqs
    only while displacement < SEQ_MOD // 4 sequences; the reorder window
    and the proxy's coalescing cap must jointly respect it."""
    findings: list[Finding] = []
    if getattr(net_cfg, "mode", "rc") != "srd":
        return findings
    rw = int(net_cfg.reorder_window)
    if rw >= SRD_DISPLACEMENT_BOUND:
        findings.append(Finding(
            "EPV-008", f"reorder_window {rw} >= SEQ_MOD // 4 = "
            f"{SRD_DISPLACEMENT_BOUND}: seq unwrap ambiguous",
            where=(rw,)))
    from repro_torch.core.transport.proxy import coalesce_cap
    cap = coalesce_cap(net_cfg)
    if cap * (rw + 1) > SRD_DISPLACEMENT_BOUND:
        findings.append(Finding(
            "EPV-008", f"coalesce cap {cap} x (reorder_window {rw} + 1) = "
            f"{cap * (rw + 1)} > SEQ_MOD // 4 = {SRD_DISPLACEMENT_BOUND}: "
            "coalesced-run displacement exceeds the unwrap window",
            where=(cap, rw)))
    return findings


# ------------------------------------------------------------------------
# session-layout check (EPV-009)
# ------------------------------------------------------------------------
def verify_session_slots(slots, *, n_channels: int,
                         counter_stride: int) -> list[Finding]:
    """Per-layer session namespaces: memory regions and guard/counter
    windows pairwise disjoint; adjacent slots' channel windows disjoint
    (the round-robin grouping guarantees exactly that much)."""
    findings: list[Finding] = []
    n = len(slots)
    for s, sl in enumerate(slots):
        if sl.ch0 + sl.ncl > n_channels:
            findings.append(Finding(
                "EPV-009", f"slot {s}: channel window [{sl.ch0}, "
                f"{sl.ch0 + sl.ncl}) exceeds n_channels {n_channels}",
                where=(s,)))
    for a in range(n):
        for b in range(a + 1, n):
            sa, sb_ = slots[a], slots[b]
            if sa.send0 < sb_.end and sb_.send0 < sa.end:
                findings.append(Finding(
                    "EPV-009", f"slots {a}/{b}: memory regions "
                    f"[{sa.send0}, {sa.end}) and [{sb_.send0}, {sb_.end}) "
                    "overlap", where=(a, b)))
            ga = (sa.guard0, sa.guard0 + counter_stride)
            gb = (sb_.guard0, sb_.guard0 + counter_stride)
            if ga[0] < gb[1] and gb[0] < ga[1]:
                findings.append(Finding(
                    "EPV-009", f"slots {a}/{b}: guard/counter windows "
                    f"[{ga[0]}, {ga[1]}) and [{gb[0]}, {gb[1]}) overlap",
                    where=(a, b)))
            if b == a + 1 and n > 1:
                ca = (sa.ch0, sa.ch0 + sa.ncl)
                cb = (sb_.ch0, sb_.ch0 + sb_.ncl)
                if ca[0] < cb[1] and cb[0] < ca[1]:
                    findings.append(Finding(
                        "EPV-009", f"adjacent slots {a}/{b} share channel "
                        f"windows [{ca[0]}, {ca[1]}) and [{cb[0]}, "
                        f"{cb[1]}): their in-flight streams would share a "
                        "wire seq space", where=(a, b)))
    return findings


# ------------------------------------------------------------------------
# omnibus entry points
# ------------------------------------------------------------------------
def verify(cs=None, *, net_cfg=None, guard_table=None, slots=None,
           n_channels: Optional[int] = None,
           counter_stride: Optional[int] = None,
           label: str = "cs") -> list[Finding]:
    """Run every applicable check for the pieces given; returns the
    (possibly empty) list of findings."""
    findings: list[Finding] = []
    if cs is not None:
        findings += verify_command_streams(cs, net_cfg=net_cfg,
                                           n_channels=n_channels,
                                           label=label)
    elif net_cfg is not None:
        findings += verify_net_config(net_cfg)
    if guard_table is not None:
        findings += verify_guard_table(guard_table)
    if slots is not None:
        findings += verify_session_slots(
            slots, n_channels=n_channels or N_CHANNELS_MAX,
            counter_stride=counter_stride or 0)
    return findings


def verify_or_raise(cs=None, **kw) -> None:
    """Raise :class:`ProtocolError` listing every finding (rule ids first)
    if any invariant fails; no-op otherwise.  ``EPWorld`` calls this at
    stream-build time, the fuzz harness on every generated stream."""
    findings = verify(cs, **kw)
    if findings:
        shown = "\n  ".join(str(f) for f in findings[:8])
        more = f"\n  ... and {len(findings) - 8} more" \
            if len(findings) > 8 else ""
        raise ProtocolError(
            f"protocol verification failed ({len(findings)} finding(s)):"
            f"\n  {shown}{more}")
