"""Paged KV-cache block allocator (vLLM-style, host-side bookkeeping).

A copy of ``repro.serve.paging``: the port imports nothing of the JAX
package, so it carries its own copy of this framework-free module.

The engine's attention KV cache is a fixed pool of ``num_pages`` pages of
``page_size`` token positions each, shared by every decode slot.  This
allocator owns the pool's free list and the per-sequence *block tables*
(logical page index -> physical page id) that the gathered-attention
kernels read through.  It is pure Python bookkeeping — device arrays never
move; admission, growth and eviction just edit integer tables.

Invariants (property-tested in ``tests/test_paged_engine.py``):

* a physical page is mapped by at most one sequence (no double-map);
* reserved pages (page 0 — the scratch page inactive decode rows write
  into) are never handed out;
* ``free + mapped + reserved`` is a partition of the pool (no leaks);
* internal fragmentation is bounded: wasted positions < n_seqs * page_size
  (each sequence wastes at most one partial page);
* the allocator is reconstructible from the block tables alone
  (:meth:`from_tables`), which is what makes the tables the single source
  of truth a restarted engine could recover from.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple


def pages_for(n_tokens: int, page_size: int) -> int:
    """Number of pages covering ``n_tokens`` positions."""
    return -(-max(n_tokens, 0) // page_size)


class BlockAllocator:
    """Fixed pool of KV pages with per-sequence block tables."""

    def __init__(self, num_pages: int, page_size: int,
                 reserved: Iterable[int] = (0,)):
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.reserved = frozenset(int(p) for p in reserved)
        if any(p < 0 or p >= self.num_pages for p in self.reserved):
            raise ValueError("reserved pages outside the pool")
        # LIFO free list: recently-freed pages are re-handed first (their
        # pool rows are most likely still warm in cache)
        self._free: List[int] = [p for p in range(self.num_pages - 1, -1, -1)
                                 if p not in self.reserved]
        self._tables: Dict[int, List[int]] = {}
        self._lens: Dict[int, int] = {}

    # ------------------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_seqs(self) -> int:
        return len(self._tables)

    def table(self, seq_id: int) -> List[int]:
        """The sequence's block table (logical order, physical page ids)."""
        return list(self._tables.get(seq_id, ()))

    def pages_used(self, seq_id: int) -> int:
        return len(self._tables.get(seq_id, ()))

    def tokens_mapped(self, seq_id: int) -> int:
        return self._lens.get(seq_id, 0)

    # ------------------------------------------------------------------
    def can_fit(self, n_tokens: int) -> bool:
        """Could a NEW sequence of ``n_tokens`` positions be mapped now?"""
        return pages_for(n_tokens, self.page_size) <= self.n_free

    def ensure(self, seq_id: int, n_tokens: int) -> bool:
        """Grow ``seq_id``'s table to cover ``n_tokens`` positions.

        All-or-nothing: on failure (pool exhausted) the table is unchanged
        and False is returned — the engine then evicts and retries.
        """
        have = len(self._tables.get(seq_id, ()))
        need = pages_for(n_tokens, self.page_size) - have
        if need <= 0:
            self._lens[seq_id] = max(self._lens.get(seq_id, 0), n_tokens)
            return True
        if need > len(self._free):
            return False
        tab = self._tables.setdefault(seq_id, [])
        for _ in range(need):
            tab.append(self._free.pop())
        self._lens[seq_id] = max(self._lens.get(seq_id, 0), n_tokens)
        return True

    def free(self, seq_id: int) -> int:
        """Release every page of ``seq_id``; returns the number freed."""
        tab = self._tables.pop(seq_id, [])
        self._lens.pop(seq_id, None)
        self._free.extend(reversed(tab))
        return len(tab)

    # ------------------------------------------------------------------
    def fragmentation(self) -> int:
        """Internal fragmentation: mapped positions not covering a token."""
        return sum(len(t) * self.page_size - self._lens[s]
                   for s, t in self._tables.items())

    def check_invariants(self) -> None:
        """Raise AssertionError on any broken pool invariant."""
        mapped = [p for t in self._tables.values() for p in t]
        assert len(mapped) == len(set(mapped)), "double-mapped page"
        assert not (set(mapped) & self.reserved), "reserved page mapped"
        assert not (set(mapped) & set(self._free)), "mapped page on free list"
        assert len(self._free) == len(set(self._free)), "free-list duplicate"
        universe = set(mapped) | set(self._free) | self.reserved
        assert universe == set(range(self.num_pages)), "page leak"
        for s, t in self._tables.items():
            assert pages_for(self._lens[s], self.page_size) <= len(t), \
                f"seq {s}: tokens beyond mapped pages"
        assert self.fragmentation() < max(self.n_seqs, 1) * self.page_size

    def snapshot(self) -> Tuple[Dict[int, List[int]], Dict[int, int]]:
        """(tables, token lens) — everything needed to reconstruct."""
        return ({s: list(t) for s, t in self._tables.items()},
                dict(self._lens))

    @classmethod
    def from_tables(cls, num_pages: int, page_size: int,
                    tables: Dict[int, List[int]], lens: Dict[int, int],
                    reserved: Iterable[int] = (0,)) -> "BlockAllocator":
        """Rebuild allocator state from block tables (crash recovery /
        the reconstruction property test)."""
        alloc = cls(num_pages, page_size, reserved)
        mapped = set()
        for s, t in tables.items():
            for p in t:
                if p in mapped or p in alloc.reserved or \
                        p < 0 or p >= num_pages:
                    raise ValueError(f"invalid page {p} in table of seq {s}")
                mapped.add(p)
            alloc._tables[s] = list(t)
            alloc._lens[s] = int(lens.get(s, len(t) * page_size))
        alloc._free = [p for p in alloc._free if p not in mapped]
        alloc.check_invariants()
        return alloc
