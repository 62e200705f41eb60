"""Block-allocated paged KV cache bookkeeping: the port of
``repro.serving.kv_cache``.

:class:`KVBlockPool` manages a fixed pool of fixed-size KV blocks with
free-list allocation and per-sequence block tables — the vLLM-style paging
model the paged decode-attention kernel
(:func:`repro_torch.kernels.ops.decode_attention_paged`) reads through;
:meth:`KVBlockPool.block_tables` lays the tables out as the kernel takes
them.  This module owns only the *metadata*: which physical block backs
which (sequence, block-index) slot.  The payload pools live with the
caller.

Invariants (asserted here and re-checked by ``assert_consistent``):

- a physical block is either on the free list or in exactly ONE sequence's
  block table, never both, never two tables (no double allocation);
- a sequence's table covers ``ceil(len / block_size)`` blocks for its
  current length — no token position exists without an allocated block;
- ``release`` returns every block of a sequence to the free list (eviction
  on completion), in deterministic LIFO order so runs are reproducible.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass
class KVBlockPool:
    n_blocks: int
    block_size: int
    free: list[int] = field(init=False)
    tables: dict[int, list[int]] = field(init=False)
    lengths: dict[int, int] = field(init=False)
    # deterministic counters
    allocs: int = 0
    frees: int = 0
    high_water: int = 0

    def __post_init__(self):
        assert self.n_blocks > 0 and self.block_size > 0
        # LIFO free list: block reuse order is deterministic
        self.free = list(range(self.n_blocks - 1, -1, -1))
        self.tables = {}
        self.lengths = {}

    # ------------------------------------------------------------ queries --
    @property
    def n_free(self) -> int:
        return len(self.free)

    @property
    def n_used(self) -> int:
        return self.n_blocks - len(self.free)

    def blocks_needed(self, seq_id: int, new_len: int) -> int:
        """How many new blocks growing ``seq_id`` to ``new_len`` tokens
        requires (0 when the current table already covers it)."""
        have = len(self.tables.get(seq_id, ()))
        need = -(-new_len // self.block_size)
        return max(0, need - have)

    def can_grow(self, seq_id: int, new_len: int) -> bool:
        return self.blocks_needed(seq_id, new_len) <= len(self.free)

    def block_table(self, seq_id: int) -> list[int]:
        return list(self.tables[seq_id])

    def block_tables(self, seq_ids, width: int | None = None,
                     device=None) -> torch.Tensor:
        """The tables of ``seq_ids`` as one (len(seq_ids), width) int32
        tensor, -1 past each table (width: the longest table by default)."""
        tabs = [self.tables[s] for s in seq_ids]
        width = max(map(len, tabs), default=0) if width is None else width
        if any(len(t) > width for t in tabs):
            raise ValueError(f"a table is longer than {width} blocks")
        out = torch.full((len(tabs), width), -1, dtype=torch.int32)
        for i, t in enumerate(tabs):
            out[i, :len(t)] = torch.tensor(t, dtype=torch.int32)
        return out.to(device) if device is not None else out

    # --------------------------------------------------------- transitions --
    def grow(self, seq_id: int, new_len: int) -> list[int]:
        """Extend ``seq_id``'s table to cover ``new_len`` tokens, allocating
        from the free list.  Raises when the pool cannot cover it — callers
        must check :meth:`can_grow` first (the scheduler's admission rule:
        no token is ever scheduled without its block allocated)."""
        n = self.blocks_needed(seq_id, new_len)
        if n > len(self.free):
            raise MemoryError(
                f"KV pool exhausted: seq {seq_id} needs {n} blocks, "
                f"{len(self.free)} free")
        tab = self.tables.setdefault(seq_id, [])
        for _ in range(n):
            tab.append(self.free.pop())
        self.lengths[seq_id] = max(self.lengths.get(seq_id, 0), new_len)
        self.allocs += n
        self.high_water = max(self.high_water, self.n_used)
        return tab[-n:] if n else []

    def release(self, seq_id: int) -> int:
        """Evict a finished sequence: return its blocks to the free list
        (reverse order — LIFO reuse) and drop its table."""
        tab = self.tables.pop(seq_id)
        self.lengths.pop(seq_id, None)
        for b in reversed(tab):
            self.free.append(b)
        self.frees += len(tab)
        return len(tab)

    # --------------------------------------------------------- invariants --
    def assert_consistent(self) -> None:
        held = [b for tab in self.tables.values() for b in tab]
        assert len(held) == len(set(held)), "block in two tables"
        assert len(self.free) == len(set(self.free)), "free-list duplicate"
        both = set(held) & set(self.free)
        assert not both, f"blocks both free and allocated: {sorted(both)}"
        universe = set(held) | set(self.free)
        assert universe == set(range(self.n_blocks)), "block leaked"
        for sid, n in self.lengths.items():
            assert len(self.tables[sid]) * self.block_size >= n, (sid, n)
