"""Request-level serving telemetry: TTFT / TPOT / queue time per request,
pool occupancy and scheduler counters, speculative-decoding acceptance,
p50/p95 aggregation.

The clock is injectable so scheduler unit tests can drive virtual time;
the server uses ``time.perf_counter``.

Speculative counters (``on_spec_round``): one *round* is a draft of
``k`` tokens plus one dense verify step.  ``acceptance_rate`` is the
fraction of drafted tokens the dense model kept; ``tokens_per_verify``
(committed tokens per round, in [1, k+1]) is the draft-efficiency
number that converts directly into decode-step amortization: each
round replaces ``committed`` vanilla dense steps with ``k`` cheap
draft steps + 1 dense verify.

Prefix-cache counters: ``prefix_hit_rate`` is the fraction of admission
lookups that matched a cached prefix; ``saved_prefill_tokens`` counts
prompt tokens whose prefill (and GRIFFIN stat accumulation) was skipped
because cached pages carried them; ``cow_copies`` counts copy-on-write
page forks (each is one device page copy); ``shared_pages_mean`` tracks
how many pool pages are multiply-referenced per step.

Attention-traffic gauge (``attn_bytes_read``): modeled HBM bytes of
paged KV the attention path read each tick, fed by the server from the
active kernel backend (the fused ``paged_attn`` kernel streams only
owned pages — O(live context); the gather oracle reads every slot's
full narrowed block-table width).  Bytes are counted at the *pool's
actual itemsize* for the server's ``kv_dtype`` — int8/fp8 pages count
1 byte per element plus their per-page scale rows, not the model
dtype's 4 (``kernels/kv_quant.py::page_bytes``).
``attn_bytes_per_token`` in ``summary()`` is the number the
``decode_attn`` benchmark tracks.  Per-request,
``prefix_hit_tokens`` records the matched prefix length — the warm/cold
TTFT split in ``benchmarks/run.py --only prefix`` comes from it.

Observability (DESIGN.md section 12): the per-step gauges live in
fixed-bucket streaming histograms on an ``obs.Registry`` — bounded
memory regardless of uptime, where the old per-step Python lists grew
forever.  The histograms carry exact ``sum``/``count``, so every mean
and total in ``summary()`` is numerically identical to the old
list-based view; only quantiles are bucket-interpolated.  A ``tracer``
(``obs.trace.Tracer``; the no-op ``NULL_TRACER`` by default) receives
the request lifecycle as async spans — emitted *here*, with the same
clock reads the timelines record, so a trace reconciles exactly with
``summary()``.  ``prometheus_text()`` / ``snapshot()`` export the
registry; abort accounting distinguishes pool-exhaustion (``oom``),
client ``cancelled`` aborts, and frontend ``shed`` decisions.

Cancellation latency (DESIGN.md section 13): the frontend stamps the
client-disconnect instant via ``on_disconnect``; the abort itself only
lands at the next tick boundary when the scheduler frees the pages and
calls ``on_finish``.  The gap — disconnect to pages-freed — is the
``serving_cancel_latency_s`` histogram, and both ends are emitted to
the tracer (``disconnect`` instant, span-end ``cancel_latency_s`` arg)
with the same clock reads, so trace and histogram reconcile exactly.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from repro_torch.obs.registry import Registry, exp_buckets, linear_buckets
from repro_torch.obs.trace import NULL_TRACER


@dataclass
class RequestTimeline:
    rid: int
    priority: int = 0
    submit_t: float = 0.0
    prefill_start_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    # client disconnect observed by the frontend; the abort lands later,
    # when the scheduler actually frees the pages — the gap is the
    # cancellation latency the frontend is on the hook for
    disconnect_t: Optional[float] = None
    prompt_tokens: int = 0
    generated_tokens: int = 0
    prefill_chunks: int = 0
    preemptions: int = 0
    aborted: bool = False
    abort_reason: Optional[str] = None  # "oom"|"cancelled"|"shed" when aborted
    draft_tokens: int = 0
    accepted_draft_tokens: int = 0
    spec_rounds: int = 0
    prefix_hit_tokens: int = 0  # prompt tokens served from cached pages
    cow_copies: int = 0

    @property
    def queue_time(self) -> Optional[float]:
        if self.prefill_start_t is None:
            return None
        return self.prefill_start_t - self.submit_t

    @property
    def ttft(self) -> Optional[float]:
        """Submit -> first generated token."""
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def cancel_latency(self) -> Optional[float]:
        """Disconnect -> pages freed (None unless both ends happened)."""
        if self.disconnect_t is None or self.finish_t is None:
            return None
        return self.finish_t - self.disconnect_t

    @property
    def tpot(self) -> Optional[float]:
        """Mean time per output token after the first."""
        if self.finish_t is None or self.first_token_t is None:
            return None
        n = self.generated_tokens - 1
        if n <= 0:
            return 0.0
        return (self.finish_t - self.first_token_t) / n


def percentile(xs: List[float], p: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), p)) if xs else 0.0


# Histogram buckets for the per-step gauges.  Occupancy is a fraction
# (bucket width 0.05); batch sizes get unit-width buckets so their
# quantiles are exact up to 64; page/byte gauges are geometric with an
# explicit 0 bucket (idle ticks).
POOL_OCCUPANCY_BUCKETS = linear_buckets(0.05, 1.0, 20)
DECODE_BATCH_BUCKETS = linear_buckets(0.0, 64.0, 65)
SHARED_PAGES_BUCKETS = (0.0,) + exp_buckets(1.0, 2.0, 15)
ATTN_BYTES_BUCKETS = (0.0,) + exp_buckets(4096.0, 2.0, 28)
# disconnect -> pages-freed latency: 100us .. ~200s geometric, plus an
# explicit 0 bucket (same-instant cancels on the fake clock)
CANCEL_LATENCY_BUCKETS = (0.0,) + exp_buckets(1e-4, 2.0, 22)


@dataclass
class ServingMetrics:
    clock: Callable[[], float] = time.perf_counter
    tracer: Any = NULL_TRACER  # obs.trace.Tracer when tracing is on
    registry: Registry = field(default_factory=Registry)
    requests: Dict[int, RequestTimeline] = field(default_factory=dict)
    # wall-clock window: first submission -> latest observed event.
    # Tracked explicitly (not reconstructed from finished requests) so
    # ``tokens_per_sec`` stays honest on drains that end with aborts or
    # zero completions — deriving the window from finished, non-aborted
    # requests only inflated throughput (or divided by the 1e-9 guard).
    first_submit_t: Optional[float] = None
    last_event_t: Optional[float] = None
    steps: int = 0
    decode_steps: int = 0
    prefill_chunks: int = 0
    preemptions: int = 0
    oom_aborts: int = 0
    cancelled_aborts: int = 0
    shed_aborts: int = 0  # dropped by SLO admission before any token
    # speculative decoding (one round = k draft steps + 1 verify step)
    spec_rounds: int = 0
    draft_tokens: int = 0
    accepted_draft_tokens: int = 0
    spec_committed_tokens: int = 0
    # rounds whose draft lengths the server clamped to its prefill-
    # interleave cap (pending prefill work must not wait behind full-k
    # spec rounds — the spec-mode TTFT guard)
    spec_capped_rounds: int = 0
    # prefix cache (radix trie over prompt prefixes, serving/prefix.py)
    prefix_lookups: int = 0
    prefix_hits: int = 0
    saved_prefill_tokens: int = 0
    prefix_inserts: int = 0
    prefix_evictions: int = 0
    prefix_evicted_refs: int = 0  # refs released across evictions
    cow_copies: int = 0

    def __post_init__(self) -> None:
        # per-step gauges as streaming histograms (bounded; the exact
        # running sum/count keeps summary() means identical to the old
        # per-step lists)
        self.pool_occupancy = self.registry.histogram(
            "serving_pool_occupancy", buckets=POOL_OCCUPANCY_BUCKETS,
            help="Pool in-use fraction per tick")
        self.decode_batch_sizes = self.registry.histogram(
            "serving_decode_batch", buckets=DECODE_BATCH_BUCKETS,
            help="Decode batch size per tick")
        self.shared_pages = self.registry.histogram(
            "serving_shared_pages", buckets=SHARED_PAGES_BUCKETS,
            help="Multiply-referenced pool pages per tick")
        # modeled HBM bytes of paged KV read by attention per tick (the
        # fused kernel streams only owned pages, the gather oracle
        # materializes the full narrowed block-table width per slot)
        self.attn_bytes_read = self.registry.histogram(
            "serving_attn_bytes_read", buckets=ATTN_BYTES_BUCKETS,
            help="Modeled HBM bytes of paged KV read by attention per tick")
        # disconnect -> pages-freed latency.  The old flow learned of an
        # abort only when ``on_finish`` fired at drain/cancel time, so
        # the disconnect instant was invisible: ``on_disconnect`` stamps
        # it and this histogram closes the loop when the pages come back
        self.cancel_latency = self.registry.histogram(
            "serving_cancel_latency_s", buckets=CANCEL_LATENCY_BUCKETS,
            help="Client disconnect -> pages freed, seconds")

    def _now(self, t: Optional[float] = None) -> float:
        """Read the clock (or take a pre-read value) and extend the
        wall-clock event window."""
        t = self.clock() if t is None else t
        if self.first_submit_t is not None:
            self.last_event_t = t if self.last_event_t is None \
                else max(self.last_event_t, t)
        return t

    # -- request lifecycle -------------------------------------------------
    def on_submit(self, rid: int, prompt_tokens: int, priority: int = 0) -> None:
        t = self.clock()
        if self.first_submit_t is None:
            self.first_submit_t = t
        self._now(t)
        self.requests[rid] = RequestTimeline(
            rid, priority=priority, submit_t=t,
            prompt_tokens=prompt_tokens,
        )
        self.tracer.abegin(rid, "request", ts=t,
                           prompt_tokens=prompt_tokens, priority=priority)

    def on_prefill_chunk(self, rid: int) -> None:
        r = self.requests[rid]
        t = self._now()
        if r.prefill_start_t is None:
            r.prefill_start_t = t
        r.prefill_chunks += 1
        self.prefill_chunks += 1
        self.tracer.ainstant(rid, "prefill_chunk", ts=t,
                             chunk=r.prefill_chunks)

    def on_first_token(self, rid: int) -> None:
        r = self.requests[rid]
        t = self._now()
        if r.first_token_t is None:
            r.first_token_t = t
            self.tracer.ainstant(rid, "first_token", ts=t)
        r.generated_tokens = max(r.generated_tokens, 1)

    def on_token(self, rid: int) -> None:
        self._now()
        self.requests[rid].generated_tokens += 1

    def on_disconnect(self, rid: int) -> None:
        """Client went away (stream closed / deadline shed decision).
        Stamps the disconnect instant; the abort itself lands later via
        ``on_finish`` when the scheduler frees the pages, and the gap
        between the two reads is the ``cancel_latency`` observation."""
        r = self.requests.get(rid)
        if r is None or r.disconnect_t is not None:
            return
        t = self._now()
        r.disconnect_t = t
        self.tracer.ainstant(rid, "disconnect", ts=t)

    def on_finish(self, rid: int, aborted: bool = False,
                  reason: str = "oom") -> None:
        """Finish a request.  ``reason`` applies only when ``aborted``:
        ``"oom"`` (pool exhaustion — the scheduler's only abort),
        ``"cancelled"`` (client-side, ``PagedServer.cancel``), or
        ``"shed"`` (frontend admission control)."""
        r = self.requests[rid]
        t = self._now()
        r.finish_t = t
        r.aborted = aborted
        if aborted:
            r.abort_reason = reason
            if reason == "oom":
                self.oom_aborts += 1
            elif reason == "shed":
                self.shed_aborts += 1
            else:
                self.cancelled_aborts += 1
            if r.disconnect_t is not None:
                self.cancel_latency.observe(max(0.0, t - r.disconnect_t))
        # end the request span with the timeline's own aggregates so a
        # trace reconciles with summary() exactly, not just closely
        self.tracer.aend(
            rid, "request", ts=t,
            generated_tokens=r.generated_tokens,
            ttft_s=r.ttft, preemptions=r.preemptions,
            spec_rounds=r.spec_rounds, prefill_chunks=r.prefill_chunks,
            cow_copies=r.cow_copies, aborted=aborted,
            reason=r.abort_reason,
            cancel_latency_s=r.cancel_latency)

    def on_spec_round(self, rid: int, drafted: int, accepted: int,
                      committed: int) -> None:
        """One draft+verify round: ``drafted`` tokens proposed,
        ``accepted`` kept by the dense model, ``committed`` tokens
        emitted (accepted + the correction/bonus, capped by max_new)."""
        r = self.requests[rid]
        r.spec_rounds += 1
        r.draft_tokens += drafted
        r.accepted_draft_tokens += accepted
        self.spec_rounds += 1
        self.draft_tokens += drafted
        self.accepted_draft_tokens += accepted
        self.spec_committed_tokens += committed
        self.tracer.ainstant(rid, "spec_round", drafted=drafted,
                             accepted=accepted, committed=committed)

    def on_spec_cap(self) -> None:
        """One spec round planned with draft lengths clamped by the
        server's prefill-interleave cap (pending prefill work)."""
        self.spec_capped_rounds += 1

    def on_preemption(self, rid: int) -> None:
        r = self.requests[rid]
        r.preemptions += 1
        self.preemptions += 1
        self.tracer.ainstant(rid, "preempt", preemptions=r.preemptions)

    # -- prefix cache ------------------------------------------------------
    def on_prefix_lookup(self, rid: int, hit_tokens: int) -> None:
        """One admission-time trie lookup; ``hit_tokens`` > 0 is a hit
        (that many prompt tokens skip prefill)."""
        self.prefix_lookups += 1
        if hit_tokens > 0:
            self.prefix_hits += 1
            self.saved_prefill_tokens += hit_tokens
            r = self.requests.get(rid)
            if r is not None:
                r.prefix_hit_tokens = max(r.prefix_hit_tokens, hit_tokens)
            self.tracer.ainstant(rid, "prefix_hit", hit_tokens=hit_tokens)

    def on_prefix_insert(self, rid: int, tokens: int) -> None:
        self.prefix_inserts += 1

    def on_prefix_evict(self, refs_released: int) -> None:
        """One trie leaf evicted under pool pressure; ``refs_released``
        is how many page references it dropped — the size signal that
        distinguishes a 1-page leaf from a long chain."""
        self.prefix_evictions += 1
        self.prefix_evicted_refs += refs_released
        self.tracer.instant("prefix_evict", cat="cache",
                            refs_released=refs_released)

    def on_cow(self, rid: int) -> None:
        """One copy-on-write page fork (one device page copy)."""
        self.cow_copies += 1
        r = self.requests.get(rid)
        if r is not None:
            r.cow_copies += 1
        self.tracer.ainstant(rid, "cow")

    # -- per-step gauges ---------------------------------------------------
    def on_step(self, pool_in_use_frac: float, decode_batch: int,
                shared_pages: int = 0,
                attn_bytes_read: float = 0.0) -> None:
        self._now()
        self.steps += 1
        if decode_batch:
            self.decode_steps += 1
        self.pool_occupancy.observe(pool_in_use_frac)
        self.decode_batch_sizes.observe(decode_batch)
        self.shared_pages.observe(shared_pages)
        self.attn_bytes_read.observe(attn_bytes_read)

    # -- aggregation -------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        done = [r for r in self.requests.values()
                if r.finish_t is not None and not r.aborted]
        aborted = [r for r in self.requests.values()
                   if r.finish_t is not None and r.aborted]
        ttfts = [r.ttft for r in done if r.ttft is not None]
        tpots = [r.tpot for r in done if r.tpot is not None]
        queues = [r.queue_time for r in done if r.queue_time is not None]
        total_tokens = sum(r.generated_tokens for r in done)
        aborted_tokens = sum(r.generated_tokens for r in aborted)
        # wall window: first submit -> latest event, tracked explicitly.
        # The old finished-only reconstruction both inflated throughput
        # (time spent on aborted work vanished from the denominator) and
        # collapsed to the 1e-9 guard on all-abort drains.
        wall = 0.0
        if self.first_submit_t is not None and self.last_event_t is not None:
            wall = self.last_event_t - self.first_submit_t
        return {
            "requests_finished": float(len(done)),
            "requests_aborted": float(
                self.oom_aborts + self.cancelled_aborts + self.shed_aborts),
            "requests_aborted_oom": float(self.oom_aborts),
            "requests_aborted_cancelled": float(self.cancelled_aborts),
            "requests_aborted_shed": float(self.shed_aborts),
            "cancel_latency_mean_s": self.cancel_latency.mean,
            "cancel_latency_p95_s": self.cancel_latency.quantile(0.95),
            "generated_tokens": float(total_tokens),
            "aborted_generated_tokens": float(aborted_tokens),
            "wall_s": float(wall),
            "tokens_per_sec": total_tokens / wall if wall > 0 else 0.0,
            "ttft_p50_s": percentile(ttfts, 50),
            "ttft_p95_s": percentile(ttfts, 95),
            "tpot_p50_s": percentile(tpots, 50),
            "queue_p50_s": percentile(queues, 50),
            "preemptions": float(self.preemptions),
            "prefill_chunks": float(self.prefill_chunks),
            "steps": float(self.steps),
            "pool_occupancy_mean": self.pool_occupancy.mean,
            "decode_batch_mean": self.decode_batch_sizes.mean,
            "spec_rounds": float(self.spec_rounds),
            "spec_capped_rounds": float(self.spec_capped_rounds),
            "draft_tokens": float(self.draft_tokens),
            # mean drafted tokens per round per request — with the
            # adaptive controller this drifts from the configured spec_k
            # toward each request's measured payoff
            "draft_k_mean": self.draft_tokens / self.spec_rounds
            if self.spec_rounds else 0.0,
            "acceptance_rate": self.accepted_draft_tokens / self.draft_tokens
            if self.draft_tokens else 0.0,
            "tokens_per_verify": self.spec_committed_tokens / self.spec_rounds
            if self.spec_rounds else 0.0,
            "prefix_hit_rate": self.prefix_hits / self.prefix_lookups
            if self.prefix_lookups else 0.0,
            "saved_prefill_tokens": float(self.saved_prefill_tokens),
            "prefix_inserts": float(self.prefix_inserts),
            "prefix_evictions": float(self.prefix_evictions),
            "prefix_evicted_refs": float(self.prefix_evicted_refs),
            "cow_copies": float(self.cow_copies),
            "shared_pages_mean": self.shared_pages.mean,
            "attn_bytes_read_total": self.attn_bytes_read.sum,
            "attn_bytes_read_mean": self.attn_bytes_read.mean,
            "attn_bytes_per_token": (
                self.attn_bytes_read.sum / total_tokens
            ) if (self.attn_bytes_read.count and total_tokens) else 0.0,
        }

    # -- export ------------------------------------------------------------
    # summary() keys that are monotone counts; the rest export as gauges
    _COUNTER_KEYS = frozenset({
        "requests_finished", "requests_aborted", "requests_aborted_oom",
        "requests_aborted_cancelled", "requests_aborted_shed",
        "generated_tokens",
        "aborted_generated_tokens", "preemptions", "prefill_chunks",
        "steps", "spec_rounds", "spec_capped_rounds", "draft_tokens",
        "saved_prefill_tokens",
        "prefix_inserts", "prefix_evictions", "prefix_evicted_refs",
        "cow_copies",
    })

    def _sync_registry(self) -> None:
        """Mirror the scalar summary into the registry so one exposition
        carries both the histograms and the counters."""
        for key, value in self.summary().items():
            name = f"serving_{key}"
            if key in self._COUNTER_KEYS:
                self.registry.counter(name).set(value)
            else:
                self.registry.gauge(name).set(value)

    def prometheus_text(self) -> str:
        self._sync_registry()
        return self.registry.prometheus_text()

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable snapshot: the summary view plus every
        registry metric (histogram buckets included)."""
        self._sync_registry()
        return {"summary": self.summary(),
                "metrics": self.registry.snapshot()["metrics"]}

    def write_snapshot(self, path: Union[str, Path]) -> Path:
        """Write the snapshot: ``.json`` -> JSON, anything else ->
        Prometheus text exposition."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        if path.suffix == ".json":
            path.write_text(json.dumps(self.snapshot(), indent=2))
        else:
            path.write_text(self.prometheus_text())
        return path
