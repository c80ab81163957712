"""Radix prefix cache: shared-prefix KV page reuse with GRIFFIN stat
carrying.

Chat-style traffic repeats the same system prompt / few-shot prefix
across most requests.  This module indexes finished prompt prefills in
a radix trie over token ids; each node maps a token prefix to

* the KV **pages** covering it (shared via ``BlockAllocator.fork``,
  copy-on-write on divergence — page lifecycle contract in
  ``serving/paged.py``),
* the accumulated GRIFFIN ``s_sq`` partial over exactly those tokens
  (the paper's eq. 6 is a plain sum over prefix tokens, so a cached
  prefix can hand its statistic to the next request and expert
  selection stays *sequence-exact* with prefill skipped), and
* the prefix **length** in tokens.

Admission (``Scheduler``) matches an incoming prompt against the trie,
forks the matched pages into the request's block table, pre-loads the
cached ``s_sq`` partial, and starts prefill at the first token past the
match.  Matches land only on node boundaries — a node stores the
statistic for exactly its own length, and a sum cannot be split at an
arbitrary token — so a prompt that diverges mid-edge reuses the deepest
fully-matched ancestor.  Under pool pressure the scheduler evicts
leaves in LRU order before preempting live requests; eviction only
drops the node's references, so pages shared with running requests
stay live until those requests finish.

Exactness: reused pages hold the very bits the donor prefill wrote, so
a prefix-warm request's decode is token-identical to a cold one
(``tests/test_prefix_cache.py`` fuzzes this differentially, including
through preemption and speculative decoding).  See DESIGN.md section 9
and ARCHITECTURE.md (Prefix cache).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.paged import BlockAllocator


@dataclass
class PrefixNode:
    """One cached prefix extension: ``tokens`` continue the parent's
    prefix up to ``length`` total tokens.

    ``pages`` cover page indices ``[page_start, ceil(length / page))``.
    When the parent's length is not page-aligned, ``page_start`` equals
    the parent's last page index: the child carries its *own* copy of
    that boundary page (the donor request COW-forked it before writing
    the divergent tokens), which overrides the parent's page on deeper
    matches.
    """
    node_id: int
    tokens: np.ndarray  # [edge_len] int32, this node's extension only
    length: int  # cumulative prefix length in tokens
    page_start: int  # first page index this node's pages cover
    pages: List[int] = field(default_factory=list)
    s_sq: Any = None  # GRIFFIN stat tree over tokens[0:length], or None
    parent: Optional["PrefixNode"] = None
    # first-token -> children starting with it (edges may share a first
    # token when one inserted edge is a prefix of a sibling's)
    children: Dict[int, List["PrefixNode"]] = field(default_factory=dict)
    last_use: int = 0

    @property
    def owner(self) -> Tuple[str, int]:
        return ("prefix", self.node_id)


@dataclass
class PrefixMatch:
    """Deepest usable cached prefix for a prompt."""
    length: int  # tokens covered
    pages: List[int]  # page ids for indices [0, ceil(length / page))
    s_sq: Any  # cached GRIFFIN partial over exactly ``length`` tokens
    node: PrefixNode


class PrefixCache:
    """Radix index over cached prompt prefixes, backed by refcounted
    pages.  Pure host logic (no device state): the scheduler owns the
    policy calls, the server applies the resulting page copies."""

    def __init__(self, alloc: BlockAllocator, page_size: int):
        self.alloc = alloc
        self.page_size = page_size
        self.root = PrefixNode(node_id=-1, tokens=np.zeros(0, np.int32),
                               length=0, page_start=0)
        self.nodes: Dict[int, PrefixNode] = {}
        self._ids = itertools.count()
        self._tick = itertools.count(1)

    # -- introspection -----------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def num_pages(self) -> int:
        """Pages referenced by the trie (disjoint across nodes)."""
        return sum(len(n.pages) for n in self.nodes.values())

    def stats(self) -> Dict[str, float]:
        """Trie shape gauges for telemetry exports (``obs.registry``):
        node/page counts, leaf count, deepest cached prefix in tokens,
        and how many trie pages live requests co-hold."""
        leaves = sum(1 for n in self.nodes.values() if not n.children)
        shared = sum(
            1 for n in self.nodes.values() for p in n.pages
            if self.alloc.ref_count(p) > 1
        )
        return {
            "nodes": float(len(self.nodes)),
            "leaves": float(leaves),
            "pages": float(self.num_pages),
            "shared_pages": float(shared),
            "max_prefix_tokens": float(
                max((n.length for n in self.nodes.values()), default=0)),
        }

    # -- walk --------------------------------------------------------------
    def _descend(self, prompt: np.ndarray, max_len: int) -> List[PrefixNode]:
        """Path of fully-matched nodes (root excluded), deepest last,
        every node's cumulative length <= max_len."""
        path: List[PrefixNode] = []
        node = self.root
        while node.length < len(prompt):
            key = int(prompt[node.length])
            best = None
            for child in node.children.get(key, ()):  # longest full match
                end = node.length + len(child.tokens)
                if end > max_len:
                    continue
                if best is not None and end <= best.length:
                    continue
                if np.array_equal(child.tokens, prompt[node.length:end]):
                    best = child
            if best is None:
                break
            path.append(best)
            node = best
        return path

    @staticmethod
    def _pages_along(path: List[PrefixNode]) -> List[int]:
        pages: List[int] = []
        for node in path:
            # a partial-boundary child overrides the parent's last page
            pages[node.page_start:] = node.pages
        return pages

    def _touch(self, path: List[PrefixNode]) -> None:
        t = next(self._tick)
        for node in path:
            node.last_use = t

    # -- policy operations -------------------------------------------------
    def match(self, prompt: np.ndarray, max_len: int,
              need_stats: bool = False) -> Optional[PrefixMatch]:
        """Deepest cached prefix of ``prompt`` usable by a new request.

        ``max_len`` caps the match (callers pass ``len(prompt) - 1`` so
        at least one real prefill token remains to produce the TTFT
        logits).  With ``need_stats`` the match backtracks to the
        deepest node that carries an ``s_sq`` partial — reusing pages
        past the statistic would silently drop those tokens from expert
        selection."""
        prompt = np.asarray(prompt, np.int32)
        path = self._descend(prompt, max_len)
        while path and need_stats and path[-1].s_sq is None:
            path.pop()
        if not path:
            return None
        self._touch(path)
        node = path[-1]
        return PrefixMatch(length=node.length,
                           pages=self._pages_along(path),
                           s_sq=node.s_sq, node=node)

    def insert(self, prompt: np.ndarray, table_pages: List[int],
               s_sq: Any) -> Optional[PrefixNode]:
        """Publish a finished prompt prefill (pages + stat partial).

        ``table_pages`` is the donor request's block table covering at
        least ``ceil(len(prompt) / page)`` pages; the trie takes its own
        references on the slice it keeps (``fork``), so the donor's
        later ``free_request`` cannot reclaim them.  An exact-duplicate
        prompt refreshes LRU (and upgrades a stat-less node) instead of
        inserting.  Returns the new node, or None."""
        prompt = np.asarray(prompt, np.int32)
        P = len(prompt)
        if P == 0:
            return None
        path = self._descend(prompt, max_len=P)
        self._touch(path)
        parent = path[-1] if path else self.root
        if parent.length == P:  # already cached
            if parent.s_sq is None and s_sq is not None:
                parent.s_sq = s_sq
            return None
        page_start = parent.length // self.page_size
        page_end = -(-P // self.page_size)
        node = PrefixNode(
            node_id=next(self._ids),
            tokens=prompt[parent.length:].copy(),
            length=P,
            page_start=page_start,
            pages=list(table_pages[page_start:page_end]),
            s_sq=s_sq,
            parent=parent,
            last_use=next(self._tick),
        )
        self.alloc.fork(node.pages, node.owner)
        parent.children.setdefault(int(node.tokens[0]), []).append(node)
        self.nodes[node.node_id] = node
        return node

    def evict_one(self) -> int:
        """Drop the least-recently-used *reclaimable* leaf node.

        Only leaves count (inner nodes hold pages their descendants'
        matches still need), and only leaves with at least one page the
        trie holds exclusively (refcount 1): evicting a leaf whose
        every page is co-held by live requests frees nothing — it would
        just destroy cache the pool pressure never benefits from.
        Returns the number of references released (0 when no leaf is
        reclaimable, telling the caller to preempt instead; preemption
        drops co-holds, which can make leaves reclaimable again)."""
        leaves = [n for n in self.nodes.values() if not n.children
                  and any(self.alloc.ref_count(p) == 1 for p in n.pages)]
        if not leaves:
            return 0
        victim = min(leaves, key=lambda n: n.last_use)
        return self._drop(victim)

    def _drop(self, node: PrefixNode) -> int:
        assert not node.children, node.node_id
        released = self.alloc.free_request(node.owner)
        siblings = node.parent.children[int(node.tokens[0])]
        siblings.remove(node)
        if not siblings:
            del node.parent.children[int(node.tokens[0])]
        del self.nodes[node.node_id]
        return released

    def flush(self) -> int:
        """Evict everything, reclaimable or not; returns references
        released."""
        released = 0
        while self.nodes:
            leaf = next(n for n in self.nodes.values() if not n.children)
            released += self._drop(leaf)
        return released
