"""Request scheduler: FCFS + priority admission, chunked prefill
interleaved into decode batches, preemption-by-eviction on pool
exhaustion.

The scheduler is engine-agnostic (pure host logic over the
``BlockAllocator``) so its fairness/preemption behavior is unit-testable
without a model.  Each ``plan_step`` yields at most one prefill chunk
plus the current decode batch; the server executes the plan on device
and reports completions back.

GRIFFIN lifecycle per request (the paper's prompt->generation split,
streamed): every prefill chunk runs the *full* FF blocks and returns the
chunk's partial ``s_sq`` statistic (eq. 6 is a sum over tokens, so
chunk-wise accumulation is exact); at the transition to decode the
accumulated statistic is reduced once (select + compact) and the request
decodes with its own compacted FF weights from then on.  A preempted
request is rescheduled recompute-style (pages freed, prefill restarts
over prompt + generated-so-far) but keeps its compacted weights — the
expert set stays the one chosen from the original prompt.

Draft/verify phase (self-speculative decoding, see ARCHITECTURE.md):
when the server runs a speculative tick instead of a one-token decode
tick, the scheduler's role is page accounting only —

* ``reserve_draft(req, k)`` grows the block table to cover the ``k``
  draft positions plus the verify bonus position *without preemption*
  (drafting is opportunistic; it must never evict a committed token's
  pages, so on pool pressure the server falls back to vanilla decode);
* the server commits accepted tokens through the ordinary
  ``finish_decode_token`` path, one per token, so telemetry, ``done``
  handling, and finish/free behavior are identical to vanilla decode;
* ``rollback_draft(req)`` returns the unused draft tail to the pool via
  ``BlockAllocator.free_pages``, leaving allocator state and block
  table bit-identical to a history that never drafted (the invariant
  ``tests/test_speculative.py`` checks; see ``free_pages`` for the
  exact scope of the free-list-order part of that claim).

KV written at rejected draft positions is left in place: it sits at
positions ``>= cache_len``, which every reader masks out and the next
committed token overwrites (page lifecycle contract in
``serving/paged.py``).

Prefix cache (``serving/prefix.py``, enabled per server): admission
matches the prompt against the radix trie — on a hit the matched pages
are forked into the request's block table, the cached ``s_sq`` partial
is pre-loaded, and prefill starts at the first token past the match.
Because shared pages are read-only, every planned write whose first
position lands in a shared page gets a copy-on-write pair
(``StepPlan.cow``) that the server applies to the device pools
(``decoder.copy_pool_pages``) before running the step.  When a prompt's
prefill completes, its pages + statistic are published back into the
trie; under pool pressure the trie evicts LRU leaves *before* any live
request is preempted.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.paged import BlockAllocator, BlockTable, PagedConfig
from repro_torch.serving.prefix import PrefixCache

QUEUED, PREFILLING, DECODING, FINISHED = "queued", "prefilling", "decoding", "finished"


class SpecController:
    """Per-request adaptive draft-length (``spec_k``) controller.

    Drafting cost should track its measured payoff: a request whose
    drafts the dense verifier keeps rejecting wastes ``k`` compacted
    steps per round to commit ~1 token, while a high-acceptance request
    leaves committed tokens on the table at small ``k``.  The server
    feeds each round's acceptance (the same numbers
    ``ServingMetrics.on_spec_round`` records) into ``observe``; the
    controller keeps an EWMA of the per-round acceptance fraction and
    moves that request's draft length one step at a time:

    * EWMA >= ``grow_at``  -> ``k += 1`` (capped at ``spec_k``),
    * EWMA <= ``shrink_at`` -> ``k -= 1`` (floored at ``min_k``),
    * in between           -> hold.

    Hysteresis (``grow_at > shrink_at``) plus the one-step moves keep
    ``k`` from oscillating on noisy acceptance.  Requests start
    optimistic at ``spec_k`` (flocking says drafts are usually good)
    and state is keyed by rid, so a preempted request resumes with its
    learned draft length; ``forget`` drops state when the request
    finishes or aborts.  The policy is a pure function of the
    acceptance trace — no clocks — so greedy token identity is
    untouched (any per-round ``k`` commits the same dense greedy
    stream) and unit tests drive it with synthetic traces
    (``tests/test_speculative.py``).
    """

    def __init__(self, spec_k: int, *, min_k: int = 1, alpha: float = 0.5,
                 grow_at: float = 0.7, shrink_at: float = 0.35):
        assert spec_k >= 1 and 1 <= min_k <= spec_k
        assert 0.0 <= shrink_at < grow_at <= 1.0 and 0.0 < alpha <= 1.0
        self.spec_k, self.min_k = spec_k, min_k
        self.alpha, self.grow_at, self.shrink_at = alpha, grow_at, shrink_at
        self._k: Dict[int, int] = {}
        self._ewma: Dict[int, float] = {}

    def k_for(self, rid: int) -> int:
        """Current draft length for ``rid`` (``spec_k`` until observed)."""
        return self._k.get(rid, self.spec_k)

    def observe(self, rid: int, drafted: int, accepted: int) -> int:
        """Fold one round's acceptance in; returns the updated ``k``.
        Rounds that drafted nothing (pool-pressure ``k_r = 0``) carry no
        acceptance signal and leave the state untouched."""
        if drafted <= 0:
            return self.k_for(rid)
        frac = accepted / drafted
        prev = self._ewma.get(rid, frac)
        ewma = self.alpha * frac + (1.0 - self.alpha) * prev
        self._ewma[rid] = ewma
        k = self.k_for(rid)
        if ewma >= self.grow_at:
            k = min(k + 1, self.spec_k)
        elif ewma <= self.shrink_at:
            k = max(k - 1, self.min_k)
        self._k[rid] = k
        return k

    def forget(self, rid: int) -> None:
        self._k.pop(rid, None)
        self._ewma.pop(rid, None)


@dataclass
class ScheduledRequest:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new: int
    priority: int = 0  # higher = served first
    seq: int = 0  # arrival order (FCFS tiebreak)
    # absolute TTFT deadline on the metrics clock (None = no deadline);
    # orders dispatch *within* a priority class and lets the frontend
    # shed requests that expired before producing a token
    deadline: Optional[float] = None
    state: str = QUEUED
    generated: List[int] = field(default_factory=list)
    prefilled: int = 0  # tokens of prefill_tokens already in pages
    table: BlockTable = field(default_factory=BlockTable)
    slot: Optional[int] = None  # decode slot while DECODING
    compacted: bool = False  # GRIFFIN selection frozen
    preemptions: int = 0
    aborted: bool = False
    # per-request sparsity tier (DESIGN.md section 16): the fraction of
    # FF experts this request keeps.  None = legacy global gcfg budget;
    # 1.0 decodes through the dense path (no compaction at all)
    tier: Optional[float] = None
    # server-managed GRIFFIN payloads (tensor trees; opaque to the scheduler)
    s_sq_acc: Any = None
    pruned_host: Any = None
    # natural per-layer buffer widths of pruned_host ({path: k}, set at
    # compaction) — the server's tick bucketing reads these
    k_widths: Any = None

    @property
    def prefill_tokens(self) -> np.ndarray:
        """Tokens that must be resident in the KV pages before decoding:
        the prompt plus every generated token already consumed as input
        (the newest generated token is written by the next decode step)."""
        if self.generated:
            return np.concatenate(
                [self.prompt, np.asarray(self.generated[:-1], np.int32)]
            )
        return self.prompt

    @property
    def cache_len(self) -> int:
        return len(self.prompt) + max(0, len(self.generated) - 1)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new


@dataclass
class PrefillWork:
    req: ScheduledRequest
    start: int  # chunk start offset into prefill_tokens
    tokens: np.ndarray  # [chunk_len] the chunk (unpadded)
    is_last: bool
    collect_stats: bool
    # resume path: generated-token positions were originally decoded with
    # the request's compacted FF weights, so their KV must be rebuilt with
    # the same weights (chunks never straddle the prompt/generated boundary)
    use_pruned: bool = False


@dataclass
class StepPlan:
    prefill: Optional[PrefillWork] = None
    decode: List[ScheduledRequest] = field(default_factory=list)
    # copy-on-write page forks the server must apply to the device
    # pools (src -> dst, decoder.copy_pool_pages) before this step's
    # writes — block tables already point at the dst pages
    cow: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return self.prefill is None and not self.decode


class Scheduler:
    def __init__(
        self,
        pcfg: PagedConfig,
        n_slots: int,
        prefill_chunk: int = 32,
        metrics: Optional[ServingMetrics] = None,
        prefix_cache: bool = False,
    ):
        self.pcfg = pcfg
        self.alloc = BlockAllocator(pcfg.num_pages)
        self.n_slots = n_slots
        self.prefill_chunk = prefill_chunk
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.prefix = PrefixCache(self.alloc, pcfg.page_size) \
            if prefix_cache else None
        # set by the server when GRIFFIN is active: only stat-carrying
        # trie nodes may serve a request that still needs to select its
        # experts, and stat-less prompts are not published
        self.needs_stats = False
        # set by the server in speculative mode: per-request adaptive
        # draft lengths (state survives preemption, dies with the
        # request — _finish/_abort call forget)
        self.spec_ctl: Optional[SpecController] = None
        self._seq = itertools.count()
        self.queue: List[ScheduledRequest] = []
        self.prefilling: Optional[ScheduledRequest] = None
        self.decoding: List[ScheduledRequest] = []
        self.finished: Dict[int, ScheduledRequest] = {}

    # -- submission --------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int, rid: int,
               priority: int = 0,
               deadline: Optional[float] = None,
               tier: Optional[float] = None) -> ScheduledRequest:
        live = list(self.queue) + list(self.decoding)
        if self.prefilling is not None:
            live.append(self.prefilling)
        if rid in self.finished or any(r.rid == rid for r in live):
            # page ownership and metrics are keyed by rid; a duplicate
            # would corrupt the allocator when either request frees
            raise ValueError(f"duplicate request id {rid}")
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) < 1 or max_new < 1:
            raise ValueError(
                f"request {rid}: need >=1 prompt token and max_new >= 1 "
                f"(got {len(prompt)}, {max_new})"
            )
        total = len(prompt) + max_new
        if total > self.pcfg.max_request_len:
            raise ValueError(
                f"request {rid}: {total} tokens > block-table capacity "
                f"{self.pcfg.max_request_len}"
            )
        req = ScheduledRequest(rid, prompt, max_new, priority=priority,
                               seq=next(self._seq), deadline=deadline,
                               tier=tier)
        self.queue.append(req)
        self.metrics.on_submit(rid, len(prompt), priority)
        return req

    # -- internals ---------------------------------------------------------
    def _queue_order(self) -> List[ScheduledRequest]:
        # priority class first, earliest deadline within a class (EDF),
        # arrival order as the final tiebreak — which also keeps plain
        # FCFS exactly as before when nobody carries a deadline
        inf = float("inf")
        return sorted(
            self.queue,
            key=lambda r: (-r.priority,
                           r.deadline if r.deadline is not None else inf,
                           r.seq),
        )

    def _preempt_one(self, needy: ScheduledRequest) -> bool:
        """Evict the lowest-priority latest-arrival decoding request —
        but only one *strictly worse* than ``needy`` (lower priority, or
        same priority and later arrival).  The strictness is the
        progress guard: without it two requests that cannot coexist in
        the pool preempt each other forever; with it the better request
        always keeps its pages, so the worse one stalls until the better
        finishes and frees them.  Returns True if pages were freed."""
        candidates = list(self.decoding)
        if self.prefilling is not None:
            candidates.append(self.prefilling)  # page-holder too
        victims = [
            r for r in candidates
            if r is not needy
            and (r.priority, -r.seq) < (needy.priority, -needy.seq)
        ]
        if not victims:
            return False
        victim = max(victims, key=lambda r: (-r.priority, r.seq))
        if victim is self.prefilling:
            self.prefilling = None
        else:
            self.decoding.remove(victim)
        self._evict(victim)
        return True

    def _evict(self, victim: ScheduledRequest) -> None:
        """Recompute-style eviction: free pages, requeue from scratch
        (a compacted request keeps its frozen expert weights)."""
        self.alloc.free_request(victim.rid)
        victim.table = BlockTable()
        victim.slot = None
        victim.prefilled = 0
        victim.preemptions += 1
        if not victim.compacted:
            victim.s_sq_acc = None  # stats restart with the re-prefill
        victim.state = QUEUED
        self.queue.append(victim)
        self.metrics.on_preemption(victim.rid)

    def _reclaim(self, needy: ScheduledRequest, need: int) -> bool:
        """Free pool pages until ``need`` are allocatable: reclaimable
        LRU prefix-cache leaves first (pure cache, nothing recomputes),
        then preemption-by-eviction — which drops co-holds and can make
        further cache leaves reclaimable, so the loop interleaves the
        two rather than wiping the cache up front.  Returns success."""
        while not self.alloc.can_alloc(need):
            if self.prefix is not None:
                released = self.prefix.evict_one()
                if released:
                    self.metrics.on_prefix_evict(released)
                    continue
            if not self._preempt_one(needy):
                return False
        return True

    def _ensure_pages(self, req: ScheduledRequest, total_tokens: int) -> bool:
        """Grow ``req``'s block table to cover ``total_tokens``,
        reclaiming (cache eviction, then preemption) if the pool is
        exhausted.  Returns success."""
        need = req.table.pages_needed(total_tokens, self.pcfg.page_size)
        if need == 0:
            return True
        if len(req.table.pages) + need > self.alloc.num_pages:
            # cannot fit even in an exclusively-owned pool: fail before
            # reclaim flushes the cache and preempts everyone for nothing
            return False
        if not self._reclaim(req, need):
            return False
        req.table.pages.extend(self.alloc.alloc(req.rid, need))
        return True

    def _cow_for_write(self, req: ScheduledRequest,
                       pos: int) -> Optional[List[Tuple[int, int]]]:
        """Make the page holding position ``pos`` exclusively ``req``'s.

        Writes may only land in exclusive pages (lifecycle contract in
        ``serving/paged.py``); the page containing the first written
        position is the only one that can be shared — later pages are
        fresh ``alloc``s.  Returns the (src, dst) device-copy pairs to
        apply (empty when already exclusive), or None when no page can
        be reclaimed for the copy (caller stalls/aborts like an
        ``_ensure_pages`` failure)."""
        idx = pos // self.pcfg.page_size
        if idx >= len(req.table.pages):
            return []
        page = req.table.pages[idx]
        if self.alloc.ref_count(page) <= 1:
            return []
        if not self._reclaim(req, 1):
            return None
        new = self.alloc.cow(req.rid, page)
        if new == page:
            # reclaim evicted the last co-holder: already exclusive,
            # no device copy needed
            return []
        req.table.pages[idx] = new
        self.metrics.on_cow(req.rid)
        return [(page, new)]

    def _try_prefix_match(self, req: ScheduledRequest) -> None:
        """Admission-time trie lookup: fork matched pages, pre-load the
        cached ``s_sq`` partial, start prefill past the match."""
        if self.prefix is None:
            return
        assert req.prefilled == 0 and not req.table.pages
        # a request that still needs expert selection must resume with
        # the exact statistic for the skipped tokens; compacted resumes
        # (frozen expert set) reuse pages from any node
        need_stats = self.needs_stats and not req.compacted
        m = self.prefix.match(req.prompt, max_len=len(req.prompt) - 1,
                              need_stats=need_stats)
        self.metrics.on_prefix_lookup(req.rid,
                                      hit_tokens=m.length if m else 0)
        if m is None:
            return
        self.alloc.fork(m.pages, req.rid)
        req.table.pages = list(m.pages)
        req.prefilled = m.length
        if need_stats:
            req.s_sq_acc = m.s_sq

    def _abort(self, req: ScheduledRequest, reason: str = "oom") -> None:
        self.alloc.free_request(req.rid)
        req.table = BlockTable()
        req.state = FINISHED
        req.aborted = True
        req.slot = None
        self.finished[req.rid] = req
        if self.spec_ctl is not None:
            self.spec_ctl.forget(req.rid)
        self.metrics.on_finish(req.rid, aborted=True, reason=reason)

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        """Client-side abort: drop the request wherever it lives and
        free its pages.  Returns False for unknown/finished rids.  Call
        between ``plan_step`` executions only — the server's ``cancel``
        wrapper guarantees that; cancelling a request the in-flight plan
        still references would free pages the step is about to write.

        ``reason`` feeds the metrics abort split: "cancelled" for client
        disconnects, "shed" when the frontend drops an expired request
        at the admission boundary (same page-freeing path, different
        accounting)."""
        for req in self.queue:
            if req.rid == rid:
                self.queue.remove(req)
                self._abort(req, reason=reason)
                return True
        if self.prefilling is not None and self.prefilling.rid == rid:
            req = self.prefilling
            self.prefilling = None
            self._abort(req, reason=reason)
            return True
        for req in self.decoding:
            if req.rid == rid:
                self.decoding.remove(req)
                self._abort(req, reason=reason)
                return True
        return False

    def lookup(self, rid: int) -> Optional[ScheduledRequest]:
        """Find a request in any state (None for unknown rids) — the
        frontend pumps streamed tokens straight off the live object."""
        req = self.finished.get(rid)
        if req is not None:
            return req
        if self.prefilling is not None and self.prefilling.rid == rid:
            return self.prefilling
        for req in itertools.chain(self.queue, self.decoding):
            if req.rid == rid:
                return req
        return None

    # -- planning ----------------------------------------------------------
    def plan_step(self) -> StepPlan:
        plan = StepPlan()
        cow_tagged: List[Tuple[int, int, int]] = []  # (rid, src, dst)

        # admission: one request prefills at a time, highest priority first
        if self.prefilling is None and self.queue \
                and len(self.decoding) < self.n_slots:
            req = self._queue_order()[0]
            self.queue.remove(req)
            req.state = PREFILLING
            self.prefilling = req
            self._try_prefix_match(req)

        # chunked prefill: at most one chunk per step
        if self.prefilling is not None:
            req = self.prefilling
            toks = req.prefill_tokens
            start = req.prefilled
            P = len(req.prompt)
            end = min(start + self.prefill_chunk, P if start < P else len(toks))
            # the chunk needs its pages, and its first written position
            # may land in a shared prefix-boundary page -> COW
            pairs = None
            if self._ensure_pages(req, end):
                pairs = self._cow_for_write(req, start)
            if pairs is None:
                if not self.decoding:
                    # nothing to evict and nothing will free pages: the
                    # request cannot ever fit
                    self.prefilling = None
                    self._abort(req)
                elif any((r.priority, -r.seq) > (req.priority, -req.seq)
                         for r in self.queue):
                    # the stall would block a strictly-better arrival
                    # behind this request for a full decoder drain —
                    # yield the prefill slot instead
                    self.prefilling = None
                    self._evict(req)
                # else: stall the chunk; decoders drain and free pages
            else:
                cow_tagged.extend((req.rid, s, d) for s, d in pairs)
                plan.prefill = PrefillWork(
                    req, start, toks[start:end], is_last=end == len(toks),
                    collect_stats=not req.compacted,
                    use_pruned=req.compacted and start >= P,
                )

        # decode batch: every decoding request advances one token; each
        # needs its next page — exclusively — before its KV write at
        # position cache_len
        stalled = []
        for req in list(self.decoding):
            if req.state != DECODING:  # preempted by an earlier iteration
                continue
            pairs = None
            if self._ensure_pages(req, req.cache_len + 1):
                pairs = self._cow_for_write(req, req.cache_len)
            if pairs is None:
                # reclaim already evicted every reclaimable cache page,
                # so any page still pinned belongs to a live request
                if self._other_page_holders(req):
                    # they will finish and free pages — sit this batch out
                    stalled.append(req)
                else:  # alone in the pool and still does not fit
                    self._abort(req)
                    self.decoding.remove(req)
            else:
                cow_tagged.extend((req.rid, s, d) for s, d in pairs)
        plan.decode = [r for r in self.decoding if r not in stalled]
        if plan.prefill is not None and plan.prefill.req is not self.prefilling:
            plan.prefill = None  # evicted by a better decoder's growth
        # drop COW pairs of requests that a later iteration evicted: an
        # evicted request's dst page went back on the free list and may
        # since have been recycled as another request's COW dst — a
        # stale pair would then collide on that dst and the scatter
        # winner is implementation-defined
        keep = {r.rid for r in plan.decode}
        if plan.prefill is not None:
            keep.add(plan.prefill.req.rid)
        plan.cow = [(s, d) for rid, s, d in cow_tagged if rid in keep]
        return plan

    def _other_page_holders(self, req: ScheduledRequest) -> bool:
        """Does any other live request currently hold pages?"""
        others = list(self.decoding)
        if self.prefilling is not None:
            others.append(self.prefilling)
        return any(r is not req and r.table.pages for r in others)

    # -- speculative drafting (page accounting only; see module docstring) --
    def reserve_draft(self, req: ScheduledRequest, k: int) -> bool:
        """Grow ``req``'s block table to cover its ``k`` draft positions
        plus the verify bonus position (``cache_len + k + 1`` tokens
        total), **without preemption** — drafting is opportunistic and
        must not evict anyone.  All-or-nothing; returns success."""
        assert req.state == DECODING, req.state
        need = req.table.pages_needed(req.cache_len + k + 1,
                                      self.pcfg.page_size)
        if need == 0:
            return True
        if req.cache_len + k + 1 > self.pcfg.max_request_len:
            return False  # block table cannot address the draft tail
        if not self.alloc.can_alloc(need):
            return False
        req.table.pages.extend(self.alloc.alloc(req.rid, need))
        return True

    def rollback_draft(self, req: ScheduledRequest) -> None:
        """Free the draft pages not needed by committed tokens.

        After the verify commit, exactly ``cache_len`` tokens of KV are
        live (the newest generated token has not been consumed yet) —
        the same coverage a vanilla decode history would hold between
        ticks.  The tail beyond that is returned via ``free_pages``,
        which restores the free list exactly (see the scope note
        there).  No-op for finished requests (``_finish`` already freed
        everything)."""
        if req.state != DECODING:
            return
        keep = -(-req.cache_len // self.pcfg.page_size)
        extra = req.table.pages[keep:]
        if extra:
            self.alloc.free_pages(req.rid, extra)
            del req.table.pages[keep:]

    # -- completion callbacks (driven by the server) -----------------------
    def finish_prefill_chunk(self, work: PrefillWork,
                             first_token: Optional[int] = None) -> None:
        req = work.req
        assert req is self.prefilling
        req.prefilled = work.start + len(work.tokens)
        self.metrics.on_prefill_chunk(req.rid)
        P = len(req.prompt)
        if self.prefix is not None and work.start < P:
            # publish the prompt prefix covered so far (chunks never
            # straddle the prompt boundary, so prefilled <= P here).
            # Inserting at *every* chunk boundary — where the exact
            # cumulative s_sq snapshot exists — is what lets a later
            # prompt that diverges mid-prompt still reuse the shared
            # head at chunk granularity.  A compacted resume
            # accumulates no stats — skip it rather than publish a
            # node stat-needing matches cannot use.
            s_sq = req.s_sq_acc if not req.compacted else None
            if s_sq is not None or not self.needs_stats:
                if self.prefix.insert(req.prompt[: req.prefilled],
                                      req.table.pages, s_sq) is not None:
                    self.metrics.on_prefix_insert(req.rid, req.prefilled)
        if not work.is_last:
            return
        # prefill complete -> decode (TTFT token comes from prefill logits
        # unless the request resumed with generated tokens in hand)
        self.prefilling = None
        if first_token is not None and not req.generated:
            req.generated.append(first_token)
            self.metrics.on_first_token(req.rid)
        req.state = DECODING
        used = {r.slot for r in self.decoding}
        req.slot = min(set(range(self.n_slots)) - used)
        self.decoding.append(req)
        if req.done:  # max_new == 1
            self._finish(req)

    def finish_decode_token(self, req: ScheduledRequest, token: int) -> None:
        req.generated.append(token)
        self.metrics.on_token(req.rid)
        if req.done:
            self._finish(req)

    def _finish(self, req: ScheduledRequest) -> None:
        if req in self.decoding:
            self.decoding.remove(req)
        self.alloc.free_request(req.rid)
        req.table = BlockTable()
        req.state = FINISHED
        req.slot = None
        self.finished[req.rid] = req
        if self.spec_ctl is not None:
            self.spec_ctl.forget(req.rid)
        self.metrics.on_finish(req.rid)

    # -- state -------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self.queue or self.prefilling or self.decoding)

    def pool_in_use_frac(self) -> float:
        return self.alloc.num_in_use / max(1, self.alloc.num_pages)

    def flush_prefix(self) -> int:
        """Drop every cached prefix (refs released; pages shared with
        live requests stay until those requests free them)."""
        return self.prefix.flush() if self.prefix is not None else 0
