"""Paged KV cache: fixed-size pages, a shared pool, per-request block
tables (the vLLM memory model).

Host side (this module): a ``BlockAllocator`` hands out page ids from a
fixed pool and tracks per-owner *references* — pages are refcounted so
several owners (requests, prefix-cache nodes) can share one physical
page.  Device side: per-layer page pools
(``models/decoder.py::init_paged_pools``) written/read by
``decode_step_paged`` through the fused paged-attention kernel or a
gather/scatter on the block tables (``kernels/paged_attn.py``,
``kernels/paged_gather.py``).

Why paging matters for GRIFFIN serving: generation-phase latency wins
(the paper's Table 3) only convert into *throughput* if the batcher can
keep many requests resident; preallocating ``max_len`` KV per slot (the
old ``ContinuousBatcher``) wastes ~60-80% of cache memory on short
requests.  Pages bound that waste to one page per request — and
refcounted sharing (``serving/prefix.py``) removes the waste of
re-prefilling the system prompt every chat request repeats.

Page lifecycle contract (who may do what, in order):

1. **Grow** — only the scheduler extends a request's block table: fresh
   pages through ``BlockAllocator.alloc`` (``Scheduler._ensure_pages``
   for committed tokens, ``Scheduler.reserve_draft`` for speculative
   scratch), shared prefix pages through ``BlockAllocator.fork``
   (prefix-cache admission hit).  Every page id in a block table is
   backed by exactly one reference held by that request.
2. **Write** — the device step writes a token's K/V into the page that
   the request's block table maps its position to; tokens without a
   page (padding, inactive slots) are redirected to the trash page.
   Positions ``>= cache_len`` may hold stale data at any time: readers
   mask ``kpos <= qpos``, so stale entries are never observable.
   **A shared page (refcount > 1) is read-only**: before any write that
   lands in one, the scheduler plans a copy-on-write fork
   (``BlockAllocator.cow`` + ``decoder.copy_pool_pages``) so the writer
   gets a private copy and every other holder keeps the original bits
   (DESIGN.md section 9).
3. **Shrink** — an owner *releases its references*, either all at once
   (``free_request``: finish, abort, preemption-eviction, prefix-node
   eviction) or as an exact tail rollback (``free_pages``: speculative-
   draft rollback).  A page returns to the free list only when its last
   reference drops.  For exclusively-held pages — draft tails always
   are — ``free_pages`` restores the allocator's free list to the state
   it would have had if the freed pages were never allocated, so a
   draft-then-rollback cycle is bit-invisible to later allocations
   (see DESIGN.md section 5).

Conservation invariant (asserted by ``check`` and fuzzed by
``tests/test_paged_properties.py``): every page is either on the free
list or referenced by at least one owner, exactly once globally —
``num_free + distinct referenced pages == num_pages`` — and a page's
refcount equals the number of owners holding it (an owner never holds
the same page twice).  No component other than the allocator may move
page ids between the free list and a block table.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class PagedConfig:
    page_size: int = 16          # tokens per KV page
    num_pages: int = 64          # pool pages per layer (excl. trash page)
    max_pages_per_request: int = 8  # block-table width (max_len / page_size)

    @property
    def max_request_len(self) -> int:
        return self.page_size * self.max_pages_per_request


class BlockAllocator:
    """Refcounting free-list page allocator.

    Owners are opaque hashables: request ids (ints) and prefix-cache
    node handles.  Invariants (asserted): a page's refcount equals the
    number of owners holding it; an owner holds a page at most once;
    ``free + distinct referenced pages == num_pages``; releasing
    returns a page to the free list exactly when its last ref drops.
    """

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages))
        self._refs: Dict[int, int] = {}  # page -> refcount (> 0)
        # owner -> pages in alloc/fork order (draft rollback pops tails)
        self._held: Dict[Hashable, List[int]] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_in_use(self) -> int:
        """Distinct pages with at least one reference."""
        return self.num_pages - len(self._free)

    @property
    def num_shared(self) -> int:
        """Pages currently referenced by more than one owner."""
        return sum(1 for c in self._refs.values() if c > 1)

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def ref_count(self, page: int) -> int:
        return self._refs.get(page, 0)

    def alloc(self, rid: Hashable, n: int) -> List[int]:
        """Allocate ``n`` fresh exclusive pages for ``rid`` (all or
        nothing)."""
        if n > len(self._free):
            raise MemoryError(f"need {n} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        held = self._held.setdefault(rid, [])
        for p in pages:
            assert p not in self._refs, (p, rid)
            self._refs[p] = 1
            held.append(p)
        return pages

    def fork(self, pages: Sequence[int], rid: Hashable) -> None:
        """Add a reference on each of ``pages`` for ``rid`` (prefix-
        cache sharing).  The pages must be live; ``rid`` must not
        already hold them.  Never consumes free pages, never fails
        under pool pressure."""
        held = self._held.setdefault(rid, [])
        for p in pages:
            assert p in self._refs, (p, rid)  # forking a dead page
            assert p not in held, (p, rid)  # double-hold would double-free
            self._refs[p] += 1
            held.append(p)

    def cow(self, rid: Hashable, page: int) -> int:
        """Copy-on-write fork: give ``rid`` a private page in place of
        the shared ``page``.

        Returns ``page`` unchanged when ``rid`` already holds it
        exclusively; otherwise pops a fresh page from the free list
        (``MemoryError`` when none is free), moves ``rid``'s reference
        onto it, and returns the new id.  The caller must then copy the
        device page contents (``decoder.copy_pool_pages``) and patch
        its block table — the allocator only does the accounting."""
        held = self._held.get(rid, [])
        assert page in held, (page, rid)
        if self._refs[page] == 1:
            return page
        if not self._free:
            raise MemoryError("cow: no free page")
        new = self._free.pop()
        assert new not in self._refs, new
        self._refs[new] = 1
        held[held.index(page)] = new
        self._refs[page] -= 1  # was > 1: never reaches 0 here
        return new

    def _release(self, page: int) -> None:
        c = self._refs[page]
        if c == 1:
            del self._refs[page]
            assert page not in self._free, page
            self._free.append(page)
        else:
            self._refs[page] = c - 1

    def free_request(self, rid: Hashable) -> int:
        """Release every reference held by ``rid``; returns the number
        of references dropped (pages only return to the free list when
        their last reference drops)."""
        pages = self._held.pop(rid, [])
        for p in pages:
            self._release(p)
        return len(pages)

    def free_pages(self, rid: Hashable, pages: List[int]) -> None:
        """Release ``rid``'s references on specific pages.

        Rollback primitive for speculative drafting: ``pages`` must be
        the *most recently allocated* pages of the request (a block-table
        tail, in allocation order).  They are released in reverse so an
        exclusively-held tail — draft tails always are — lands back on
        the free list exactly where it came from, making the free list
        (and therefore every subsequent ``alloc``) bit-identical to a
        history in which the tail was never handed out.

        Scope of the bit-identity claim: it holds when rollbacks unwind
        the allocation stack LIFO — a single drafting request, or a
        multi-request tick rolled back in reverse reservation order
        (the server does this).  If several requests *keep* draft pages
        that interleave on the stack, the free *set* and ownership are
        still exact but the free-list order can differ from the
        never-drafted history (allocation correctness is unaffected;
        only deterministic replay of page ids would notice).
        """
        held = self._held.get(rid, [])
        for p in reversed(pages):
            assert p in held, (p, rid)
            held.remove(p)
            self._release(p)

    def pages_of(self, rid: Hashable) -> List[int]:
        return sorted(self._held.get(rid, []))

    def holders_snapshot(self) -> Dict[Hashable, List[int]]:
        """Copy of the owner -> pages map (tests / debugging)."""
        return {o: list(ps) for o, ps in self._held.items() if ps}

    def check(self) -> None:
        assert len(self._free) == len(set(self._free))
        assert not (set(self._free) & set(self._refs))
        # conservation: free + distinct referenced == pool
        assert len(self._free) + len(self._refs) == self.num_pages
        # refcounts match the holder map exactly; no owner double-holds
        counted: Dict[int, int] = {}
        for owner, pages in self._held.items():
            assert len(pages) == len(set(pages)), owner
            for p in pages:
                counted[p] = counted.get(p, 0) + 1
        assert counted == self._refs, (counted, self._refs)


@dataclass
class BlockTable:
    """Per-request logical-position -> pool-page mapping."""
    pages: List[int] = field(default_factory=list)

    def as_array(self, width: int) -> np.ndarray:
        bt = np.full((width,), -1, np.int32)
        bt[: len(self.pages)] = self.pages
        return bt

    def pages_needed(self, num_tokens: int, page_size: int) -> int:
        """Extra pages required to hold ``num_tokens`` total tokens."""
        want = -(-num_tokens // page_size)  # ceil
        return max(0, want - len(self.pages))
