"""Paged serving front-end: ``submit`` / ``step`` / ``drain`` (port of
``repro/serving/server.py``, vanilla GRIFFIN serving).

Execution model per ``step()`` (one scheduler tick):

  0. copy-on-write page forks planned by the scheduler are applied to
     the device pools (``decoder.copy_pool_pages``) — shared prefix
     pages are read-only, so a writer first gets a private copy,
  1. at most one prefill chunk of the highest-priority admitted request
     runs through the full model (GRIFFIN stats streamed per chunk; the
     ``expert_stat`` kernel on the card) — with the prefix cache a
     request whose prompt prefix is cached starts at the first divergent
     token with the cached ``s_sq`` partial pre-loaded,
  2. the decode batch advances every DECODING request: by one token in a
     single call over ``n_slots`` padded slots, on per-slot compacted FF
     weights selected at the request's first decode (vanilla), or by up
     to ``spec_k + 1`` tokens per request in a speculative round (below).

All host state (block tables, positions, tokens) lives in the
scheduler's request objects; the model, pools, statistics and compacted
weights live on ``device`` (the card unless ``device="cpu"``).  The
gather backend narrows block tables to the tick's live context (the
widest request's page count, rounded up to a power of two); the fused
kernel gets them at full width, so its split plan, and with it every
request's logits, do not depend on the batch (``_live_width``).  The
pools and the per-slot compacted buffers are updated in place.

Attention backends (``kernel_backend``): ``fused`` runs the paged
attention kernel (``kernels/paged_attn.py``), ``gather`` the
gather-then-attend path (``paged_gather`` kernel on the card), ``auto``
fused on CUDA and gather on the CPU.  ``kv_dtype`` picks the pools' byte
format (``kernels/kv_quant.py``): ``fp32`` (the model dtype), ``bf16``,
or ``int8``/``fp8`` pages behind per-page-per-head scale pools, served by
both backends; attention bytes per token follow the pool's format.  Greedy tokens come from
``torch.argmax`` on the device, which picks the first maximum like the
reference's ``np.argmax``.

Self-speculative decoding (``spec_k > 0``, needs ``gcfg``): the
per-slot GRIFFIN-compacted FF weights are the draft model and the dense
model verifies.  One round per decode batch:

  1. **plan + reserve** (``_plan_spec``) — each request drafts ``k_r =
     min(k_adaptive, prefill cap, remaining budget - 1, capacity
     headroom)`` tokens and reserves their pages plus one bonus position
     without preemption (``Scheduler.reserve_draft``); a failed
     reservation drafts 0.  ``k_adaptive`` comes from the request's
     ``SpecController`` (``adaptive_spec``); while a prompt prefills,
     ``k_r`` is capped at ``spec_prefill_cap``.  When nobody can draft,
     the tick decodes one token **dense**: with ``spec_k`` the compacted
     weights are only ever the draft.
  2. **draft + verify** — ``spec_impl="fused"``: one
     ``decoder.draft_verify_paged`` call (draft loop on the compacted
     weights, then the dense ``[n_slots, spec_k+1]`` verify) with no host
     sync inside, and one host transfer of the drafts and verify logits
     after it; ``"per_token"`` keeps the host loop (a step and a sync per
     draft token) and a standalone ``verify_step_paged`` as the
     differential oracle.
  3. **commit + rollback** — ``sampling.greedy_verify`` commits accepted
     drafts plus one correction or bonus token through the scheduler's
     callbacks; ``Scheduler.rollback_draft`` returns unused draft pages,
     so allocator state equals never having drafted.

Greedy speculative output is token-identical to dense greedy decode
(``gcfg=None``); resumes after preemption rebuild dense too, and drafts
always compact at the global budget (tiers change nothing).

Flocking telemetry (``flocking_every > 0``, needs ``gcfg``): every N
ticks, before the decode or speculative step, a dense ``decode_step_paged``
with ``collect_stats`` runs over the same inputs and feeds
``obs.flocking.FlockingMonitor``.  The port's steps write the pools in
place (the reference's probe writes into a copy it throws away), so the
probe saves the page each probed row writes — position ``cache_len`` —
and the trash page, in every layer's K/V pool and scale pool, and writes
them back after the probe: serving state is bit-identical around it.

Tensor parallelism (``mesh=``, a ``launch.mesh.ServingMesh``): one
server per rank, each process of the mesh running this class on its own
shard (``distributed/tp.py``): pools hold the rank's KV heads, the
parameters its heads and FF block, and every step runs the rank's
``PagedTP`` wrapper, whose all-reduces make the logits identical on every
rank.  All host logic in this file is rank-agnostic; every rank is given
the same submissions.  The GRIFFIN statistics are global after each
prefill chunk; each rank selects on them (``tp_shards=N``,
``per_shard_topk``, forced as in the reference) and compacts its own
F-block, so no rank ever holds the whole FF.  Each rank records its own
step time under its shard id (``obs.stragglers``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import griffin as griffin_lib
from repro_torch.distributed.tp import PagedTP
from repro_torch.kernels import backend as backend_lib
from repro_torch.kernels import kv_quant
from repro_torch.models import decoder
from repro_torch.models.layers.attention import resolve_attn_backend
from repro_torch.obs.flocking import FlockingMonitor
from repro_torch.obs.stragglers import StepTimeMonitor
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serving import sampling
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.paged import PagedConfig
from repro_torch.serving.scheduler import (
    DECODING,
    FINISHED,
    PrefillWork,
    ScheduledRequest,
    Scheduler,
    SpecController,
)


class PagedServer:
    def __init__(
        self,
        cfg,
        params: Dict,
        gcfg: Optional[griffin_lib.GriffinConfig] = None,
        *,
        page_size: int = 16,
        num_pages: int = 96,
        n_slots: int = 4,
        prefill_chunk: int = 32,
        max_len: int = 256,
        spec_k: int = 0,
        spec_impl: str = "fused",
        adaptive_spec: bool = True,
        spec_prefill_cap: int = 1,
        prefix_cache: bool = True,
        kernel_backend: str = "auto",
        kv_dtype: str = "fp32",
        metrics: Optional[ServingMetrics] = None,
        mesh=None,
        tracer: Optional[Tracer] = None,
        flocking_every: int = 0,
        profile: Optional[griffin_lib.SparsityProfile] = None,
        default_tier: Optional[float] = None,
        device=None,
    ):
        assert decoder.supports_paged(cfg), (
            f"{cfg.name}: paged serving covers attention families only"
        )
        self.kv_dtype = kv_quant.resolve_kv_dtype(kv_dtype)
        if mesh is not None and device is not None \
                and torch.device(device).type != mesh.device.type:
            raise ValueError(f"device {device} but the mesh's rank runs on "
                             f"{mesh.device}")
        self.device = backend_lib.resolve_device(
            mesh.device if mesh is not None else device)
        self.backend = resolve_attn_backend(kernel_backend, self.device)
        self.gcfg = gcfg if (gcfg is not None and cfg.griffin and cfg.has_ffn) \
            else None
        self.mesh = mesh
        self.tp: Optional[PagedTP] = None
        if mesh is not None:
            self.tp = PagedTP(cfg, mesh, backend=self.backend,
                              kv_dtype=self.kv_dtype)
            if self.gcfg is not None and (
                self.gcfg.tp_shards != self.tp.n
                or not self.gcfg.per_shard_topk
            ):
                # balanced rank-local selection with k_ff padded to a
                # multiple of the axis, which the rank-local compaction
                # needs.  To reproduce the sharded outputs on one device,
                # give the single-device server the same gcfg
                # (tp_shards=N): the selection is the same math.
                self.gcfg = self.gcfg.replace(
                    tp_shards=self.tp.n, per_shard_topk=True
                )
            params = self.tp.shard_params(params, self.device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(
                f"params live on {table.device}, the server on {self.device}"
            )
        self.cfg, self.params = cfg, params
        self.pcfg = PagedConfig(
            page_size=page_size, num_pages=num_pages,
            max_pages_per_request=-(-max_len // page_size),
        )
        self.n_slots = n_slots
        if spec_k and self.gcfg is None:
            raise ValueError(
                "spec_k needs gcfg: the GRIFFIN-compacted weights are the "
                "draft model"
            )
        if spec_impl not in ("fused", "per_token"):
            raise ValueError(
                f"spec_impl: 'fused' (one draft+verify call per round) or "
                f"'per_token' (host-loop differential oracle), got "
                f"{spec_impl!r}"
            )
        self.spec_k = spec_k
        self.spec_impl = spec_impl
        self.spec_prefill_cap = spec_prefill_cap
        # per-layer profiles + request tiers
        self.profile = profile
        self.default_tier = griffin_lib.resolve_tier(default_tier)
        if (profile is not None or self.default_tier is not None) \
                and self.gcfg is None:
            raise ValueError(
                "sparsity profile/tier needs gcfg: tiers scale the "
                "GRIFFIN per-layer expert budgets"
            )
        self._k_trees: Dict[float, Dict[int, int]] = {}  # tier -> plan_k_tree
        self._ffn_F = griffin_lib.ffn_widths(cfg) if self.gcfg is not None \
            else {}
        # tick bucketing state: the widths signature the installed slot
        # buffers were padded to, and which request each slot holds
        self._bucket_sig = None
        self._slot_rid: Dict[int, int] = {}
        self.sched = Scheduler(self.pcfg, n_slots, prefill_chunk,
                               metrics=metrics, prefix_cache=prefix_cache)
        self.sched.needs_stats = self.gcfg is not None
        if spec_k and adaptive_spec:
            self.sched.spec_ctl = SpecController(spec_k)
        self.pools = decoder.init_paged_pools(cfg, num_pages, page_size,
                                              self.kv_dtype, self.device) \
            if self.tp is None else \
            self.tp.init_pools(num_pages, page_size, self.device)
        # per-slot compacted FF: {li: {leaf: [n_slots, ...]}}
        self.pruned_slots: Optional[Dict[int, Dict]] = None
        # live requests holding a compacted FF copy (``pruned_host``),
        # released when they finish (see ``_release_finished``)
        self._compacted: Dict[int, ScheduledRequest] = {}
        self._next_rid = 0
        self._tick_attn_bytes = 0.0  # modeled KV read bytes, this tick
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.sched.metrics.tracer = self.tracer
        self.steps_mon = StepTimeMonitor(self.sched.metrics.registry)
        if flocking_every and self.gcfg is None:
            raise ValueError(
                "flocking_every needs gcfg: the telemetry compares the "
                "GRIFFIN expert selection against decode activations"
            )
        self.flocking_every = flocking_every
        self.flocking = FlockingMonitor(self.gcfg, self.sched.metrics.registry,
                                        cfg) if flocking_every else None
        self._tick_no = 0

    # -- device calls --------------------------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _step_model(self, bt, toks, pos, mask, pruned, collect=False):
        """One paged step: (logits [B,S,V], pools, stats or None); under a
        mesh the rank's shard, with global statistics."""
        args = (self.params, self.pools, self._tensor(bt), self._tensor(toks),
                self._tensor(pos), self._tensor(mask))
        if self.tp is not None:
            if collect:
                return self.tp.prefill(*args, pruned, True)
            return self.tp.decode(*args, pruned) + (None,)
        return decoder.decode_step_paged(
            self.params, self.cfg, *args[1:5], write_mask=args[5],
            pruned=pruned, collect_stats=collect, backend=self.backend,
            kv_dtype=self.kv_dtype,
        )

    def _draft_verify(self, bts, toks, pos, k_r, live, pruned,
                      num_steps: int):
        """One fused speculative round on the device: (drafts [B,
        num_steps], verify logits [B, spec_k+1, V]) as device tensors."""
        args = (self.params, self.pools, self._tensor(bts), self._tensor(toks),
                self._tensor(pos), self._tensor(k_r), self._tensor(live), pruned)
        if self.tp is not None:
            drafts, vlogits, _ = self.tp.draft_verify(
                *args, num_steps=num_steps, spec_k=self.spec_k)
        else:
            drafts, vlogits, _ = decoder.draft_verify_paged(
                self.params, self.cfg, *args[1:], num_steps=num_steps,
                spec_k=self.spec_k, backend=self.backend,
                kv_dtype=self.kv_dtype,
            )
        return drafts, vlogits

    def _verify(self, bts, toks, pos, mask) -> torch.Tensor:
        """The standalone dense verify step: logits [B, k+1, V]."""
        args = (self.params, self.pools, self._tensor(bts), self._tensor(toks),
                self._tensor(pos), self._tensor(mask))
        if self.tp is not None:
            return self.tp.verify(*args)[0]
        vlogits, _ = decoder.verify_step_paged(
            self.params, self.cfg, *args[1:],
            backend=self.backend, kv_dtype=self.kv_dtype,
        )
        return vlogits

    # -- API ---------------------------------------------------------------
    @property
    def metrics(self) -> ServingMetrics:
        return self.sched.metrics

    def reset_metrics(self) -> ServingMetrics:
        """Swap in a fresh ``ServingMetrics`` (same clock + tracer) and
        re-home the registry-backed monitors on it.

        For steady-state measurement: drain a warmup trace first, call
        this, then run the timed trace — percentiles, counters and the
        throughput window then cover only post-warmup requests.  Call
        only between drains (no live requests).  Serving state is
        untouched: pages, prefix cache and adaptive ``spec_k`` controller
        state all survive."""
        old = self.sched.metrics
        if self.sched.has_work:
            raise RuntimeError(
                "reset_metrics with live requests would drop their timelines")
        fresh = ServingMetrics(clock=old.clock, tracer=old.tracer)
        self.sched.metrics = fresh
        self.steps_mon = StepTimeMonitor(fresh.registry)
        if self.flocking is not None:
            self.flocking = FlockingMonitor(self.gcfg, fresh.registry, self.cfg)
        return fresh

    def submit(self, prompt: np.ndarray, max_new: int,
               rid: Optional[int] = None, priority: int = 0,
               deadline: Optional[float] = None,
               tier: Optional[float] = None) -> int:
        """``tier`` (one of ``griffin.TIERS``): the fraction of FF experts
        this request keeps — 1.0 decodes dense.  None falls back to the
        server's ``default_tier`` (itself None -> the global ``gcfg``
        budget).  In speculative mode tiers change nothing: drafts use the
        global budget and the dense verifier commits every token."""
        tier = griffin_lib.resolve_tier(tier)
        if tier is not None and self.gcfg is None:
            raise ValueError(
                f"request tier {tier} needs gcfg: tiers scale the "
                f"GRIFFIN per-layer expert budgets"
            )
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid + 1)
        self.sched.submit(prompt, max_new, rid, priority, deadline=deadline,
                          tier=tier)
        return rid

    def step(self) -> bool:
        """One scheduler tick; returns True while work remains."""
        tr = self.tracer
        metrics = self.sched.metrics
        t0 = metrics.clock()
        self._tick_no += 1
        with tr.span("tick", tick=self._tick_no):
            with tr.span("plan"):
                plan = self.sched.plan_step()
            if plan.cow:
                # copy-on-write forks: duplicate shared page bits into the
                # writers' fresh pages before any of this tick's writes
                with tr.span("cow_copy", pairs=len(plan.cow)):
                    decoder.copy_pool_pages(
                        self.cfg, self.pools,
                        self._tensor(np.asarray([s for s, _ in plan.cow], np.int64)),
                        self._tensor(np.asarray([d for _, d in plan.cow], np.int64)),
                    )
            if plan.prefill is not None:
                with tr.span("prefill_chunk", rid=plan.prefill.req.rid,
                             start=plan.prefill.start,
                             tokens=len(plan.prefill.tokens)):
                    self._run_prefill(plan.prefill)
            if plan.decode:
                if self.flocking is not None \
                        and self._tick_no % self.flocking_every == 0:
                    # dense probe before the decode/spec step; the pages
                    # it writes are restored
                    with tr.span("flocking_probe", cat="obs",
                                 batch=len(plan.decode)):
                        self._run_flocking_probe(plan.decode)
                ks = self._plan_spec(plan.decode, plan) if self.spec_k \
                    else None
                if ks:
                    with tr.span("spec_round", batch=len(plan.decode),
                                 drafted=sum(ks.values())):
                        self._run_speculative(plan.decode, ks)
                else:
                    with tr.span("decode", batch=len(plan.decode)):
                        self._run_decode(plan.decode)
            metrics.on_step(self.sched.pool_in_use_frac(),
                            len(plan.decode),
                            shared_pages=self.sched.alloc.num_shared,
                            attn_bytes_read=self._tick_attn_bytes)
        self._tick_attn_bytes = 0.0
        self._release_finished()
        if self.flocking is not None:
            for rid in [r for r in self.flocking.live_rids()
                        if r in self.sched.finished]:
                self.flocking.on_finish(rid)
        dur = metrics.clock() - t0
        self.steps_mon.on_tick(
            dur, None if self.tp is None else {self.tp.rank: dur})
        tr.counter("pool", occupancy=self.sched.pool_in_use_frac(),
                   decode_batch=len(plan.decode),
                   shared_pages=self.sched.alloc.num_shared)
        return self.sched.has_work

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        """Client-side abort (between ticks): drop the request wherever
        it lives, free its pages, count it as a ``cancelled`` (or
        ``shed``) abort.  Returns False for unknown or already-finished
        rids."""
        ok = self.sched.cancel(rid, reason=reason)
        self._release_finished()
        if ok and self.flocking is not None:
            self.flocking.on_finish(rid)
        return ok

    def _release_finished(self) -> None:
        """Drop the compacted FF copy of every request that finished or
        was aborted.  The scheduler keeps finished requests (their tokens)
        for good, and at Yi-9B width one copy is ~6.5 GB on the card, so a
        long-running server must not keep them; a preempted request keeps
        its copy to resume with.  Once no request holds one, the slot
        buffers go too (a one-slot server's are views of the last
        request's copy): the next request compacts beside the weights
        alone."""
        for rid, req in list(self._compacted.items()):
            if req.state == FINISHED:
                req.pruned_host = None
                del self._compacted[rid]
        if not self._compacted and self.pruned_slots is not None:
            self.pruned_slots, self._bucket_sig, self._slot_rid = None, None, {}

    def drain(self) -> Dict[int, List[int]]:
        """Run until idle; returns generated tokens per finished request."""
        while self.step():
            pass
        self.sync_prefix_gauges()
        return {rid: r.generated for rid, r in self.sched.finished.items()
                if not r.aborted}

    def sync_prefix_gauges(self) -> None:
        """Mirror the prefix trie's shape onto registry gauges."""
        if self.sched.prefix is None:
            return
        for k, v in self.sched.prefix.stats().items():
            self.metrics.registry.gauge(
                f"serving_prefix_{k}",
                help="Prefix-trie shape gauge (see PrefixCache.stats)",
            ).set(v)

    # -- live-context narrowing + modeled attention traffic ----------------
    def _live_width(self, reqs: List[ScheduledRequest]) -> int:
        """Block-table width for this call.  The fused kernel always gets
        ``max_pages_per_request``: its page-split plan follows the table
        width, so a width that followed the widest request of the batch
        would make a request's logits depend on who shares its tick, and
        bf16 greedy streams would change with the schedule (pages past a
        request's count leave their split empty).  The gather path takes
        the widest request's page count, rounded up to a power of two."""
        W = self.pcfg.max_pages_per_request
        if self.backend == "fused":
            return W
        n = max((len(r.table.pages) for r in reqs), default=1)
        w = 1
        while w < max(n, 1):
            w *= 2
        return min(w, W)

    def _count_attn_bytes(self, pos: List[int], S: int, width: int,
                          rows: int) -> None:
        """Accumulate this call's modeled bytes of KV read by attention
        (the ``attn_bytes_read`` per-tick gauge): the fused kernel streams
        ``ceil((pos+S)/page)`` owned pages per live request; the gather
        path materializes ``width`` pages for every row."""
        page = self.pcfg.page_size
        per_page = kv_quant.page_bytes(
            page, self.cfg.num_kv_heads, self.cfg.head_dim,
            self.kv_dtype, self.cfg.dtype,
        )
        if self.backend == "fused":
            pages = sum(-(-(p + S) // page) for p in pos)
        else:
            pages = rows * width
        self._tick_attn_bytes += float(
            self.cfg.num_layers * pages * per_page
        )

    # -- phases ------------------------------------------------------------
    def _run_prefill(self, work: PrefillWork) -> None:
        req, chunk = work.req, self.sched.prefill_chunk
        Lc = len(work.tokens)
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :Lc] = work.tokens
        mask = np.zeros((1, chunk), bool)
        mask[0, :Lc] = True
        Wl = self._live_width([req])
        bt = req.table.as_array(Wl)[None]
        pos = np.array([work.start], np.int32)
        self._count_attn_bytes([work.start], Lc, Wl, rows=1)
        collect = work.collect_stats and self.gcfg is not None
        # resume of a compacted request: generated-token positions must
        # rebuild their KV with the same FF weights that decoded them —
        # the compacted ones in vanilla GRIFFIN mode, the dense ones in
        # speculative mode (the dense verifier committed every token)
        use_pruned = work.use_pruned and not self.spec_k \
            and req.pruned_host is not None
        pruned = self._expand_b1(req.pruned_host) if use_pruned else None
        with self.tracer.annotation("prefill_chunk"):
            logits, _, stats = self._step_model(bt, toks, pos, mask, pruned,
                                                collect)
        if collect:
            part = decoder.prune_stats_tree(stats, self.cfg)
            # a fresh tree, never an in-place add: the prefix cache may
            # hold the previous accumulator
            req.s_sq_acc = part if req.s_sq_acc is None else {
                li: {k: req.s_sq_acc[li][k] + v for k, v in st.items()}
                for li, st in part.items()
            }
        first_token = None
        if work.is_last and not req.generated:
            first_token = int(torch.argmax(logits[0, Lc - 1]))
        self.sched.finish_prefill_chunk(work, first_token)
        if work.is_last and req.state == DECODING and self.gcfg is not None:
            if not req.compacted:
                tier = req.tier if req.tier is not None else self.default_tier
                if self.spec_k:
                    # drafts always use the global budget: the dense
                    # verifier commits every token, so a tier would
                    # change speed, never outputs
                    tier = None
                if tier == 1.0:
                    # dense tier: no selection, no compacted buffers
                    req.pruned_host = None
                    req.k_widths = None
                else:
                    ffn_tree = decoder.extract_ffn_tree(self.params, self.cfg)
                    ks = None if tier is None else self._k_tree(tier)
                    # telemetry compares against the global budget, so
                    # tiered requests are not tracked; at that budget the
                    # compaction's own selection is ``select_tree``'s
                    sel = {} if self.flocking is not None and tier is None \
                        else None
                    # under a mesh: the global selection, this rank's
                    # experts compacted from its own FF block
                    req.pruned_host, req.k_widths = \
                        griffin_lib.select_and_compact(
                            req.s_sq_acc, ffn_tree, self.gcfg, ks=ks,
                            on_select=None if sel is None
                            else sel.__setitem__,
                            shard=None if self.tp is None
                            else (self.tp.rank, self.tp.n))
                    if sel is not None:
                        self.flocking.on_select(req.rid, sel, req.s_sq_acc)
                    self._compacted[req.rid] = req
                req.compacted = True
                req.s_sq_acc = None
            # slot install is deferred to the decode tick
            # (_sync_pruned_slots): the buffer width every request pads
            # to depends on which tiers share that tick

    def _decode_inputs(self, reqs: List[ScheduledRequest]):
        """Padded one-token decode inputs for the batch: each request's
        newest token at its ``cache_len`` position."""
        B, W = self.n_slots, self._live_width(reqs)
        toks = np.zeros((B, 1), np.int32)
        pos = np.zeros((B,), np.int32)
        mask = np.zeros((B, 1), bool)
        bts = np.full((B, W), -1, np.int32)
        for req in reqs:
            s = req.slot
            toks[s, 0] = req.generated[-1]
            pos[s] = req.cache_len
            mask[s, 0] = True
            bts[s] = req.table.as_array(W)
        return toks, pos, mask, bts, W

    def _run_decode(self, reqs: List[ScheduledRequest]) -> None:
        B = self.n_slots
        toks, pos, mask, bts, W = self._decode_inputs(reqs)
        # spec mode: the compacted weights are only the draft — a vanilla
        # tick (nobody could draft) decodes dense, or its tokens and KV
        # drift from the dense stream the verifier commits
        use_griffin = self.gcfg is not None and not self.spec_k
        pruned = self._sync_pruned_slots(reqs) if use_griffin else None
        dense_rows = [r for r in reqs if r.pruned_host is None] \
            if use_griffin else list(reqs)
        pruned_rows = [r for r in reqs if r.pruned_host is not None] \
            if use_griffin else []
        if pruned is None:
            groups = [(None, list(reqs))]
        elif not dense_rows:
            groups = [(pruned, list(reqs))]
        else:
            # mixed tick: compacted tiers share one padded-width pruned
            # call; tier-1.0 rows run the unmodified dense model in a
            # second call.  Each call masks the other group's rows, so KV
            # writes and committed tokens never mix.
            groups = [(pruned, pruned_rows), (None, dense_rows)]
        next_tok: Dict[int, int] = {}
        for pr, group in groups:
            gmask = mask
            if len(group) != len(reqs):
                gmask = np.zeros_like(mask)
                for r in group:
                    gmask[r.slot] = mask[r.slot]
            self._count_attn_bytes([r.cache_len for r in group], 1, W,
                                   rows=B)
            with self.tracer.annotation("decode_step"):
                logits, _, _ = self._step_model(bts, toks, pos, gmask, pr)
            best = torch.argmax(logits[:, 0], dim=-1).tolist()  # [slots]
            for r in group:
                next_tok[r.slot] = best[r.slot]
        for req in reqs:
            self.sched.finish_decode_token(req, next_tok[req.slot])

    # -- flocking telemetry (obs/flocking.py) ------------------------------
    def _run_flocking_probe(self, reqs: List[ScheduledRequest]) -> None:
        """Dense stats probe over the live decode batch: one un-pruned
        ``decode_step_paged`` with ``collect_stats`` on the same inputs
        the coming decode tick uses; only the per-slot ``s_sq`` rows feed
        the monitor.

        The step writes each probed row's K/V in place, and with int8/fp8
        pools may grow that page's scale and re-encode the page; masked
        rows of the gather path land in the trash page.  Those pages, in
        every layer's pools and scale pools, are saved before the probe
        and written back after it, so the pools are bit-identical around
        it."""
        probed = [r for r in reqs if r.compacted and r.generated]
        if not probed:
            return
        toks, pos, mask, bts, _ = self._decode_inputs(probed)
        page = self.pcfg.page_size
        touched = {self.pcfg.num_pages}  # the trash page
        touched.update(int(bts[r.slot, r.cache_len // page]) for r in probed)
        idx = self._tensor(np.asarray(sorted(touched), np.int64))
        saved = [{k: kv_quant.as_bytes(buf).index_select(0, idx)
                  for k, buf in pool.items()} for pool in self.pools]
        try:
            with self.tracer.annotation("flocking_probe"):
                _, _, stats = self._step_model(bts, toks, pos, mask, None,
                                               collect=True)
        finally:
            for pool, snap in zip(self.pools, saved):
                for k, buf in pool.items():
                    kv_quant.as_bytes(buf).index_copy_(0, idx, snap[k])
        part = decoder.prune_stats_tree(stats, self.cfg)
        results = self.flocking.on_probe(
            {r.rid: r.slot for r in probed}, part)
        for rid, v in results.items():
            self.tracer.ainstant(rid, "flocking", jaccard=v["jaccard"],
                                 angular=v["angular"])

    # -- speculative draft / verify / commit / rollback --------------------
    def _plan_spec(self, reqs: List[ScheduledRequest],
                   plan) -> Optional[Dict[int, int]]:
        """Per-request draft lengths for a speculative round, pages
        reserved: ``k_r = min(k_adaptive, prefill cap, remaining budget -
        1, capacity headroom)``.  ``k_adaptive`` is the request's learned
        draft length (``SpecController``; ``spec_k`` when it is off).
        While a prompt is prefilling (a chunk in this plan, or a request
        mid-prefill) ``k_r`` is capped at ``spec_prefill_cap``, so its
        chunks interleave with short rounds; merely queued prompts do not
        engage the cap.  A request whose reservation fails (pool
        pressure) drafts 0: its verify row is a dense decode step.
        Returns ``rid -> k_r``, or None when nobody can draft (the tick
        decodes dense)."""
        if not all(r.compacted for r in reqs):
            return None
        ctl = self.sched.spec_ctl
        prefill_pending = (plan.prefill is not None
                           or self.sched.prefilling is not None)
        cap = self.spec_prefill_cap if prefill_pending else self.spec_k
        ks: Dict[int, int] = {}
        capped = False
        for r in reqs:
            want = ctl.k_for(r.rid) if ctl is not None else self.spec_k
            k = max(0, min(want,
                           r.max_new - len(r.generated) - 1,
                           self.pcfg.max_request_len - r.cache_len - 1))
            if k > cap:
                k = cap
                capped = True
            if k and not self.sched.reserve_draft(r, k):
                k = 0
            ks[r.rid] = k
        if not any(ks.values()):
            return None
        if capped:
            self.sched.metrics.on_spec_cap()
        return ks

    def _run_speculative(self, reqs: List[ScheduledRequest],
                         ks: Dict[int, int]) -> None:
        """One draft/verify/commit/rollback round for the decode batch
        (per-request draft lengths and pages planned by ``_plan_spec``)."""
        K = self.spec_k
        B, W = self.n_slots, self._live_width(reqs)
        bts = np.full((B, W), -1, np.int32)
        base = {r.rid: r.cache_len for r in reqs}
        last = {r.rid: r.generated[-1] for r in reqs}
        draft: Dict[int, List[int]] = {r.rid: [] for r in reqs}
        for req in reqs:
            bts[req.slot] = req.table.as_array(W)
        num_steps = max(ks.values())
        # every request compacts at the global budget in spec mode, so
        # the slot buffers have one width
        pruned = self._sync_pruned_slots(reqs)

        # modeled attention traffic: draft iteration ``i`` reads for the
        # requests still inside their ``k_r`` only, the verify one row per
        # planned request
        for i in range(num_steps):
            live = [r for r in reqs if i < ks[r.rid]]
            self._count_attn_bytes([base[r.rid] + i for r in live], 1, W,
                                   rows=len(live))
        self._count_attn_bytes([base[r.rid] + ks[r.rid] for r in reqs], 1, W,
                               rows=len(reqs))

        if self.spec_impl == "fused":
            toks = np.zeros((B, 1), np.int32)
            pos = np.zeros((B,), np.int32)
            kr = np.zeros((B,), np.int32)
            live = np.zeros((B,), bool)
            for req in reqs:
                s = req.slot
                toks[s, 0] = last[req.rid]
                pos[s] = base[req.rid]
                kr[s] = ks[req.rid]
                live[s] = True
            with self.tracer.annotation("draft_verify"):
                dr, vl = self._draft_verify(bts, toks, pos, kr, live, pruned,
                                            num_steps)
                # the round's one host transfer: drafts (int32 bits) beside
                # the verify logits
                host = torch.cat([vl.reshape(B, -1), dr.view(torch.float32)],
                                 dim=1).cpu().numpy()
            vlogits = host[:, :-num_steps].reshape(vl.shape)
            dr = host[:, -num_steps:].view(np.int32)
            for req in reqs:
                draft[req.rid] = [int(t) for t in dr[req.slot, : ks[req.rid]]]
        else:
            for i in range(num_steps):
                toks = np.zeros((B, 1), np.int32)
                pos = np.zeros((B,), np.int32)
                mask = np.zeros((B, 1), bool)
                for req in reqs:
                    s = req.slot
                    toks[s, 0] = last[req.rid]
                    pos[s] = base[req.rid] + i
                    mask[s, 0] = i < ks[req.rid]
                logits, _, _ = self._step_model(bts, toks, pos, mask, pruned)
                best = torch.argmax(logits[:, 0], dim=-1).tolist()  # [slots]
                for req in reqs:
                    if i < ks[req.rid]:
                        draft[req.rid].append(best[req.slot])
                        last[req.rid] = best[req.slot]
            vtoks = np.zeros((B, K + 1), np.int32)
            vpos = np.zeros((B,), np.int32)
            vmask = np.zeros((B, K + 1), bool)
            for req in reqs:
                s, kr = req.slot, ks[req.rid]
                vtoks[s, 0] = req.generated[-1]
                vtoks[s, 1 : kr + 1] = draft[req.rid]
                vpos[s] = base[req.rid]
                vmask[s, : kr + 1] = True
            with self.tracer.annotation("verify_step"):
                vlogits = self._verify(bts, vtoks, vpos, vmask).cpu().numpy()

        # commit through the vanilla callbacks; the round's telemetry and
        # the controller see it *before* the commits, since the last
        # commit may finish the request (``done`` is a generated-count
        # check, so the commit count is known up front)
        for req in reqs:
            kr = ks[req.rid]
            committed, n_acc = sampling.greedy_verify(
                vlogits[req.slot, : kr + 1], draft[req.rid])
            n_commit = min(len(committed), req.max_new - len(req.generated))
            if kr:
                self.sched.metrics.on_spec_round(
                    req.rid, drafted=kr, accepted=n_acc, committed=n_commit)
                if self.sched.spec_ctl is not None:
                    self.sched.spec_ctl.observe(req.rid, kr, n_acc)
            for tok in committed:
                if req.done:
                    break
                self.sched.finish_decode_token(req, tok)
        # unused draft tails go back in reverse reservation order, so the
        # rollbacks unwind the allocator's LIFO stack exactly
        for req in reversed(reqs):
            self.sched.rollback_draft(req)

    # -- per-slot GRIFFIN weights ------------------------------------------
    def _k_tree(self, tier: float) -> Dict[int, int]:
        """Per-layer expert budgets for a tier (cached per server)."""
        if tier not in self._k_trees:
            self._k_trees[tier] = griffin_lib.plan_k_tree(
                self.cfg, self.gcfg, tier=tier, profile=self.profile)
        return self._k_trees[tier]

    def _tick_widths(self, reqs: List[ScheduledRequest]) -> Dict[int, int]:
        """Buffer width per FF layer for this tick's compacted batch.

        A single-width batch keeps its natural widths.  Mixed widths
        bucket to the next power of two above the tick's max (rounded to
        a ``tp_shards`` multiple, capped at ``d_ff``); padding is
        bit-exact (zero ``w2`` rows)."""
        sigs = {tuple(sorted(r.k_widths.items())) for r in reqs}
        if len(sigs) == 1:
            return dict(next(iter(sigs)))
        sh = self.gcfg.tp_shards
        out = {}
        for li, F in self._ffn_F.items():
            m = max(r.k_widths[li] for r in reqs)
            w = 1 << (m - 1).bit_length()
            if sh > 1:
                w = -(-w // sh) * sh
            out[li] = min(F, w)
        return out

    def _sync_pruned_slots(self, reqs: List[ScheduledRequest]
                           ) -> Optional[Dict[int, Dict]]:
        """Bring ``self.pruned_slots`` up to date for this tick's batch
        and return it (None when nobody needs compacted weights).

        Buffers are installed lazily per (slot, rid): while the tick's
        width signature is stable only requests that newly entered (or
        moved) a slot are written; a width change rebuilds every live
        slot at the new bucket."""
        pruned_reqs = [r for r in reqs if r.pruned_host is not None]
        if not pruned_reqs:
            return None
        widths = self._tick_widths(pruned_reqs)
        sig = tuple(sorted(widths.items()))
        if sig != self._bucket_sig:
            self._bucket_sig = sig
            self.pruned_slots = None
            self._slot_rid = {}
        shards = self.gcfg.tp_shards
        if self.tp is not None:
            # a rank holds its block of every width; per-shard padding at
            # each block's tail is, on the rank, padding at the tail
            widths = {li: w // self.tp.n for li, w in widths.items()}
            shards = 1
        for r in pruned_reqs:
            if self._slot_rid.get(r.slot) != r.rid:
                self._install_pruned(
                    r.slot,
                    griffin_lib.pad_pruned_tree(r.pruned_host, widths,
                                                shards=shards),
                )
                self._slot_rid[r.slot] = r.rid
        return self.pruned_slots

    @staticmethod
    def _expand_b1(pruned1: Dict[int, Dict]) -> Dict[int, Dict]:
        """A request's compacted FF tree in the batch-of-1 slot layout
        ``decode_step_paged`` expects (leading slot axis)."""
        return {li: {k: v[None] for k, v in ffn.items()}
                for li, ffn in pruned1.items()}

    def _install_pruned(self, slot: int, pruned1: Dict[int, Dict]) -> None:
        """Write one request's compacted FF tree into its decode slot, in
        place.  The first install of a width allocates the
        ``[n_slots, ...]`` buffers (every slot starts as a copy of this
        request's weights, as the reference's broadcast does).  A server
        of one slot holds views of the request's own tree instead, and
        rebinds them at every install: no second copy of the compacted FF
        (at GRIFFIN 0.5, half of the model's FF weights: Gemma-3-27B fits
        on one card only so), and nothing is written into a tree that a
        preempted request keeps for its resume."""
        if self.n_slots == 1:
            self.pruned_slots = self._expand_b1(pruned1)
            return
        if self.pruned_slots is None:
            self.pruned_slots = {
                li: {k: v[None].expand((self.n_slots,) + v.shape).clone()
                     for k, v in ffn.items()}
                for li, ffn in pruned1.items()
            }
            return
        for li, ffn in pruned1.items():
            buf = self.pruned_slots[li]
            for k, v in ffn.items():
                buf[k][slot].copy_(v)
