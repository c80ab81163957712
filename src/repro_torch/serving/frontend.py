"""Continuous-batching async serving frontend over ``PagedServer``.

The engine (``PagedServer.step``) stays a synchronous host-driven tick
loop — that is what makes it deterministic and testable.  This module
adds the concurrent edge around it:

* **streaming** — ``submit`` returns a :class:`StreamHandle`; tokens are
  pumped off the live ``ScheduledRequest`` after every tick, so clients
  see each token as soon as the engine commits it, not at drain;
* **continuous batching** — admission is evaluated every tick:
  frontend-pending requests are moved into the scheduler (in SLO order)
  whenever its queue has room, so new arrivals join the running batch
  instead of waiting for a drain boundary;
* **backpressure** — the frontend holds at most ``max_pending``
  undispatched requests; past that, ``submit`` raises
  :class:`QueueFull` and the HTTP surface answers 429.  The scheduler's
  own queue is kept at ``queue_depth`` so SLO reordering happens in the
  frontend (cheap, shed-able) rather than in a deep engine queue;
* **SLO classes + deadlines** — each request carries an absolute TTFT
  deadline derived from its :class:`~repro_torch.serving.slo.SLOClass`;
  deadlines order dispatch within a priority class (EDF, see
  ``Scheduler._queue_order``) and expired requests that have not yet
  produced a token are **shed** at the admission boundary;
* **cancellation** — a client disconnect marks the handle; the next
  tick routes it through ``PagedServer.cancel`` so pages are freed at a
  tick boundary (never under an in-flight plan), the oom/cancelled/shed
  abort split and the ``serving_cancel_latency_s`` histogram record it.

Determinism contract (the load-bearing design constraint — DESIGN.md
section 13): ``tick()`` is synchronous and does *all* state
transitions; the async machinery (``run``, the HTTP handlers) only
decides *when* ticks happen and never mutates scheduling state itself.
Time is read exclusively through ``self.clock`` (defaults to the
engine metrics clock), so a test binds a ``FakeClock`` and drives
``tick()`` by hand — every admission/shed/cancel interleaving is then
a pure function of (submission order, explicit clock advances, tick
count).  ``run()`` contains **no wall-clock sleeps**: it yields with
``asyncio.sleep(0)`` while the engine has work and parks on an
``asyncio.Event`` when idle.  ``tick()`` runs ``server.step()`` inside the
event loop, so on the card one tick holds the loop for that tick's wall
time (model work included); handlers get their turn between ticks.

Shedding policy: only requests with **zero produced tokens** are ever
shed — frontend-pending ones, and scheduler-``QUEUED`` ones that are
not preempted resumes (a preempted request already produced tokens and
keeps them).  Once a request starts prefilling it is past admission
and runs to completion even if its deadline lapses (the miss is
recorded, the work is not wasted).

HTTP surface (stdlib-only, ``asyncio.start_server`` + hand-rolled
HTTP/1.1 — the container has no aiohttp, and the parser is ~40 lines):

* ``POST /v1/generate``  body ``{"prompt": [ints], "max_new": n,
  "slo": "interactive|standard|batch", "deadline_s": f?}`` →
  ``text/event-stream`` with one ``data: {"token": t}`` event per
  token and a terminal ``event: done`` / ``event: error``;
* ``GET /metrics``  Prometheus text exposition of the engine registry
  (frontend counters included — same registry);
* ``GET /healthz``  liveness + queue depths.

Handlers read/write only ``asyncio.StreamReader``/``StreamWriter``, so
tests drive them over in-memory pipes — no sockets in tier-1.

On a tensor-parallel mesh the frontend runs on rank 0 over a
``serving.relay.MeshLeader``, which relays each tick's engine calls to
the other ranks.  Unlike the reference, ``serve_http`` returns after
``stop()`` and fails with a tick's exception.
"""
from __future__ import annotations

import asyncio
import json
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.griffin import resolve_tier as griffin_resolve_tier
from repro_torch.serving.scheduler import QUEUED, ScheduledRequest
from repro_torch.serving.slo import DEFAULT_SLO, SLOClass, resolve_slo

__all__ = ["ServingFrontend", "StreamHandle", "QueueFull", "RequestRejected",
           "PENDING", "ACTIVE", "FINISHED", "CANCELLED", "SHED", "ABORTED"]

# StreamHandle lifecycle states
PENDING = "pending"      # accepted by the frontend, not yet in the scheduler
ACTIVE = "active"        # submitted to the engine
FINISHED = "finished"    # completed normally; all tokens delivered
CANCELLED = "cancelled"  # client disconnect -> pages freed
SHED = "shed"            # deadline expired before any token; dropped
ABORTED = "aborted"      # engine-side abort (pool exhaustion)

_TERMINAL = (FINISHED, CANCELLED, SHED, ABORTED)

# stream event kinds pushed into a handle's queue (kind, payload)
_EV_TOKEN = "token"
_EV_END = "end"


class QueueFull(RuntimeError):
    """Admission queue at capacity — HTTP 429 on the wire."""


class RequestRejected(ValueError):
    """Request can never be served (too long / malformed) — HTTP 400."""


class StreamHandle:
    """One in-flight generation: an async iterator over its tokens.

    The frontend owns all mutation (from ``tick``); consumers only read
    ``tokens``/``state`` or iterate.  ``cancel()`` is the disconnect
    edge: it stamps the instant and wakes the loop — the actual abort
    happens at the next tick boundary.
    """

    def __init__(self, frontend: "ServingFrontend", rid: int,
                 prompt: np.ndarray, max_new: int, slo: SLOClass,
                 deadline: Optional[float], submit_t: float):
        self._frontend = frontend
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.slo = slo
        self.deadline = deadline  # absolute, on the frontend clock
        self.submit_t = submit_t
        self.state = PENDING
        self.finish_reason: Optional[str] = None
        self.tokens: List[int] = []  # every token pumped so far
        self.slo_met: Optional[bool] = None  # set at terminal transition
        self.cancel_requested = False
        self._sched_ref: Optional[ScheduledRequest] = None
        self._emitted = 0  # tokens moved from sched_ref.generated
        self._pending_seq = 0  # FCFS tiebreak, set by the frontend
        self._events: asyncio.Queue = asyncio.Queue()

    # -- consumer side ------------------------------------------------------
    def cancel(self) -> None:
        """Client disconnect: record the instant, let the next tick
        route it through ``PagedServer.cancel``.  Idempotent; a no-op
        once terminal."""
        if self.cancel_requested or self.state in _TERMINAL:
            return
        self.cancel_requested = True
        if self.state == ACTIVE:
            # stamp disconnect on the engine timeline now — the abort
            # lands at the next tick; the gap is the cancel latency
            self._frontend.metrics.on_disconnect(self.rid)
        self._frontend._wake.set()

    @property
    def done(self) -> bool:
        return self.state in _TERMINAL

    def __aiter__(self) -> "StreamHandle":
        return self

    async def __anext__(self) -> int:
        kind, payload = await self.next_event()
        if kind == _EV_TOKEN:
            return payload
        raise StopAsyncIteration

    async def next_event(self) -> Tuple[str, Any]:
        """Next stream event: ``("token", t)`` or ``("end", reason)``.
        After the end event, repeats it (never blocks forever)."""
        if self._events.empty() and self.done:
            return (_EV_END, self.finish_reason)
        ev = await self._events.get()
        return ev

    async def result(self) -> List[int]:
        """Drain the stream; returns all tokens (empty on shed)."""
        async for _ in self:
            pass
        return self.tokens

    # -- frontend side (called from tick only) ------------------------------
    def _push_token(self, t: int) -> None:
        self.tokens.append(t)
        self._events.put_nowait((_EV_TOKEN, t))

    def _terminal(self, state: str, reason: str) -> None:
        assert self.state not in _TERMINAL
        self.state = state
        self.finish_reason = reason
        self._events.put_nowait((_EV_END, reason))


class ServingFrontend:
    """Async edge around a ``PagedServer`` (or any engine exposing
    ``sched``/``metrics``/``n_slots`` and ``submit/step/cancel`` — the
    model-free ``SimServer`` satisfies the same contract for tests)."""

    def __init__(self, server: Any, *, max_pending: int = 64,
                 queue_depth: Optional[int] = None,
                 default_slo: Union[str, SLOClass] = DEFAULT_SLO,
                 clock: Any = None):
        self.server = server
        self.sched = server.sched
        self.metrics = server.sched.metrics
        self.tracer = self.metrics.tracer
        self.clock = clock if clock is not None else self.metrics.clock
        self.max_pending = int(max_pending)
        # scheduler-queue cap: keep the deep reorder buffer here in the
        # frontend (shed-able, SLO-sorted every tick) and only enough in
        # the engine queue to keep admission busy
        self.queue_depth = int(queue_depth) if queue_depth is not None \
            else 2 * server.n_slots
        self.default_slo = resolve_slo(default_slo)
        self._pending: List[StreamHandle] = []
        self._active: Dict[int, StreamHandle] = {}
        self.handles: Dict[int, StreamHandle] = {}  # every accepted handle
        self._next_rid = 0
        self._pending_seq = 0
        self._wake = asyncio.Event()
        self._running = False
        # bounded-cardinality registry counters (labels: slo class /
        # shed reason only — never request ids)
        reg = self.metrics.registry
        self._c_submitted = {
            name: reg.counter("frontend_requests_total",
                              labels={"slo": name},
                              help="Requests accepted by the frontend")
            for name in self._slo_label_names()
        }
        self._c_rejected = reg.counter(
            "frontend_rejected_total",
            help="Submissions refused at admission (queue full)")
        self._c_slo = {
            ok: reg.counter("frontend_slo_total",
                            labels={"outcome": "met" if ok else "missed"},
                            help="Completed requests by SLO outcome")
            for ok in (True, False)
        }
        self._g_pending = reg.gauge(
            "frontend_pending_depth",
            help="Requests waiting in the frontend admission queue")

    def _slo_label_names(self) -> List[str]:
        from repro_torch.serving.slo import SLO_CLASSES
        names = sorted(SLO_CLASSES)
        if self.default_slo.name not in names:
            names.append(self.default_slo.name)
        return names

    # -- submission ---------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int, *,
               slo: Union[str, SLOClass, None] = None,
               deadline_s: Optional[float] = None,
               priority: Optional[int] = None,
               tier: Optional[float] = None) -> StreamHandle:
        """Accept a request (synchronous — callable from handlers and
        tests alike).  Raises :class:`QueueFull` under backpressure and
        :class:`RequestRejected` for unservable requests.

        ``deadline_s`` overrides the class TTFT deadline (relative
        seconds from now); ``priority`` overrides the class priority;
        ``tier`` (one of ``griffin.TIERS``) overrides the class
        sparsity tier — the fraction of FF experts the request keeps."""
        cls = resolve_slo(slo if slo is not None else self.default_slo)
        if tier is not None:
            try:
                tier = griffin_resolve_tier(tier)
            except ValueError as e:
                raise RequestRejected(str(e)) from None
            cls = SLOClass(cls.name, cls.priority, cls.ttft_deadline_s,
                           tier=tier)
        if cls.tier is not None and getattr(self.server, "gcfg", None) is None:
            raise RequestRejected(
                f"tier {cls.tier} needs a GRIFFIN-enabled server")
        prompt = np.asarray(prompt, np.int32)
        max_new = int(max_new)
        if len(prompt) < 1 or max_new < 1:
            raise RequestRejected(
                f"need >=1 prompt token and max_new >= 1 "
                f"(got {len(prompt)}, {max_new})")
        cap = self.sched.pcfg.max_request_len
        if len(prompt) + max_new > cap:
            raise RequestRejected(
                f"{len(prompt) + max_new} tokens > capacity {cap}")
        if len(self._pending) >= self.max_pending:
            self._c_rejected.inc()
            raise QueueFull(
                f"admission queue full ({self.max_pending} pending)")
        now = self.clock()
        rel = deadline_s if deadline_s is not None else cls.ttft_deadline_s
        deadline = (now + rel) if rel is not None else None
        if priority is not None:
            cls = SLOClass(cls.name, int(priority), cls.ttft_deadline_s,
                           tier=cls.tier)
        h = StreamHandle(self, self._next_rid, prompt, max_new, cls,
                         deadline, now)
        self._next_rid += 1
        h._pending_seq = self._pending_seq
        self._pending_seq += 1
        self._pending.append(h)
        self.handles[h.rid] = h
        if cls.name in self._c_submitted:
            self._c_submitted[cls.name].inc()
        self.tracer.instant("frontend_submit", cat="frontend", ts=now,
                            rid=h.rid, slo=cls.name)
        self._wake.set()
        return h

    # -- the deterministic tick --------------------------------------------
    def tick(self) -> bool:
        """One frontend step: apply cancels, shed expired, admit, run
        one engine tick, pump tokens/terminal states.  Synchronous and
        side-effect-complete — tests call it directly; ``run()`` just
        schedules it.  Returns True while any work remains."""
        now = self.clock()
        self._apply_cancels()
        self._shed_expired(now)
        self._admit()
        if self.sched.has_work:
            self.server.step()
        self._pump()
        self._g_pending.set(float(len(self._pending)))
        return self.has_work

    @property
    def has_work(self) -> bool:
        return bool(self._pending or self._active or self.sched.has_work)

    def run_until_idle(self, max_ticks: int = 100_000) -> None:
        """Synchronous drive for tests and the load generator: tick
        until nothing remains (guarding against livelock bugs with a
        tick budget — a stall here is a scheduler invariant violation,
        so fail loudly rather than spin)."""
        for _ in range(max_ticks):
            if not self.tick():
                return
        raise RuntimeError(f"frontend not idle after {max_ticks} ticks")

    def _apply_cancels(self) -> None:
        # pending cancels never touched the engine: terminal directly
        for h in [h for h in self._pending if h.cancel_requested]:
            self._pending.remove(h)
            h._terminal(CANCELLED, "cancelled")
            self.tracer.instant("frontend_cancel_pending", cat="frontend",
                                rid=h.rid)
        # active cancels go through the engine so pages are freed at a
        # tick boundary; _pump observes the abort and finalizes
        for h in list(self._active.values()):
            if h.cancel_requested and h._sched_ref.state != "finished":
                self.server.cancel(h.rid, reason="cancelled")

    def _shed_expired(self, now: float) -> None:
        """Drop expired requests that have produced nothing.  Runs
        before admission and before the engine tick, so an expired
        QUEUED request is shed before ``plan_step`` could start its
        prefill.  Requests past admission (PREFILLING/DECODING) and
        preempted resumes (QUEUED but with tokens) are never shed."""
        for h in [h for h in self._pending
                  if h.deadline is not None and now > h.deadline]:
            self._pending.remove(h)
            self._finalize_shed(h)
        for h in list(self._active.values()):
            r = h._sched_ref
            if (h.deadline is not None and now > h.deadline
                    and r.state == QUEUED and not r.generated):
                self.server.cancel(h.rid, reason="shed")
                # _pump translates the abort into the SHED terminal

    def _finalize_shed(self, h: StreamHandle) -> None:
        h.slo_met = False
        h._terminal(SHED, "shed")
        self._c_slo[False].inc()
        self.tracer.instant("frontend_shed", cat="frontend", rid=h.rid,
                            slo=h.slo.name)

    def _admit(self) -> None:
        """Move pending requests into the scheduler, SLO-ordered
        (priority class, then earliest deadline, then arrival), while
        its queue has room.  The engine applies the same EDF order, so
        frontend and scheduler never disagree about who goes next."""
        room = self.queue_depth - len(self.sched.queue)
        if room <= 0 or not self._pending:
            return
        inf = float("inf")
        order = sorted(
            self._pending,
            key=lambda h: (-h.slo.priority,
                           h.deadline if h.deadline is not None else inf,
                           h._pending_seq))
        for h in order[:room]:
            self._pending.remove(h)
            # tier only when set: untiered admission stays compatible
            # with engine-shaped servers that predate the tier kwarg
            kw = {} if h.slo.tier is None else {"tier": h.slo.tier}
            self.server.submit(h.prompt, h.max_new, rid=h.rid,
                               priority=h.slo.priority, deadline=h.deadline,
                               **kw)
            h._sched_ref = self.sched.lookup(h.rid)
            assert h._sched_ref is not None
            h.state = ACTIVE
            self._active[h.rid] = h

    def _pump(self) -> None:
        """Move newly committed tokens onto each stream and translate
        engine-terminal states into handle-terminal states."""
        for rid, h in list(self._active.items()):
            r = h._sched_ref
            gen = r.generated
            while h._emitted < len(gen):
                h._push_token(gen[h._emitted])
                h._emitted += 1
            if r.state != "finished":
                continue
            del self._active[rid]
            if not r.aborted:
                self._finalize_complete(h)
            else:
                reason = self.metrics.requests[rid].abort_reason
                if reason == "shed":
                    self._finalize_shed(h)
                elif reason == "cancelled":
                    h._terminal(CANCELLED, "cancelled")
                else:
                    h._terminal(ABORTED, reason or "oom")

    def _finalize_complete(self, h: StreamHandle) -> None:
        tl = self.metrics.requests[h.rid]
        # SLO outcome is TTFT vs deadline on the shared clock; no
        # deadline means trivially met
        h.slo_met = (h.deadline is None
                     or (tl.first_token_t is not None
                         and tl.first_token_t <= h.deadline))
        h._terminal(FINISHED, "complete")
        self._c_slo[h.slo_met].inc()

    # -- aggregate view -----------------------------------------------------
    def summary(self) -> Dict[str, float]:
        """Frontend-level SLO aggregates over every accepted handle;
        engine-level numbers live in ``metrics.summary()``."""
        hs = list(self.handles.values())
        done = [h for h in hs if h.state == FINISHED]
        shed = [h for h in hs if h.state == SHED]
        met = [h for h in done if h.slo_met]
        ttfts = []
        for h in done:
            tl = self.metrics.requests.get(h.rid)
            if tl is not None and tl.ttft is not None:
                ttfts.append(tl.ttft)
        wall = 0.0
        if self.metrics.first_submit_t is not None \
                and self.metrics.last_event_t is not None:
            wall = self.metrics.last_event_t - self.metrics.first_submit_t
        goodput_tokens = sum(len(h.tokens) for h in met)
        out = {
            "accepted": float(len(hs)),
            "rejected": float(self._c_rejected.value),
            "completed": float(len(done)),
            "shed": float(len(shed)),
            "cancelled": float(sum(h.state == CANCELLED for h in hs)),
            "aborted_oom": float(sum(h.state == ABORTED for h in hs)),
            "slo_met": float(len(met)),
            "slo_met_rate": len(met) / len(done) if done else 0.0,
            # goodput = tokens from SLO-met completions per wall second:
            # work delivered late (or shed) earns nothing
            "goodput_tokens_per_sec":
                goodput_tokens / wall if wall > 0 else 0.0,
            "shed_rate": len(shed) / len(hs) if hs else 0.0,
            "ttft_p50_s": _percentile(ttfts, 50),
            "ttft_p99_s": _percentile(ttfts, 99),
        }
        return out

    # -- async drive --------------------------------------------------------
    def stop(self) -> None:
        self._running = False
        self._wake.set()

    async def run(self) -> None:
        """Drive ticks until ``stop()``.  No wall-clock sleeps: yield
        control with ``sleep(0)`` while the engine has work (handlers
        get a turn between ticks), park on the wake event when idle."""
        self._running = True
        try:
            while self._running:
                self.tick()
                if not self._running:
                    break
                if self.has_work:
                    await asyncio.sleep(0)
                else:
                    self._wake.clear()
                    # no awaits between has_work and clear(): a submit
                    # landing after the check re-sets the event before
                    # we wait, so the wake is never lost
                    await self._wake.wait()
        finally:
            self._running = False

    # -- HTTP/SSE surface ---------------------------------------------------
    async def serve_http(self, host: str = "127.0.0.1",
                         port: int = 8100) -> None:
        """Bind and serve until cancelled or ``stop()``ped; runs the tick
        loop alongside the acceptor, and a tick that fails ends the
        serving with its exception.  Production entry point
        (``launch/serve.py --http``) — tests drive ``handle_connection``
        directly."""
        server = await asyncio.start_server(self.handle_connection,
                                            host, port)
        runner = asyncio.ensure_future(self.run())
        acceptor = asyncio.ensure_future(server.serve_forever())
        try:
            async with server:
                await asyncio.wait({runner, acceptor},
                                   return_when=asyncio.FIRST_COMPLETED)
        finally:
            self.stop()
            acceptor.cancel()
            await asyncio.gather(acceptor, return_exceptions=True)
            await runner

    async def handle_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        try:
            try:
                method, path, _headers, body = await _read_request(reader)
            except (ValueError, asyncio.IncompleteReadError,
                    ConnectionError):
                return  # malformed/empty request: just close
            if method == "GET" and path == "/healthz":
                await self._respond_json(writer, 200, {
                    "ok": True,
                    "pending": len(self._pending),
                    "active": len(self._active),
                })
            elif method == "GET" and path == "/metrics":
                text = self.metrics.prometheus_text()
                await self._respond(writer, 200, text.encode(),
                                    "text/plain; version=0.0.4")
            elif method == "POST" and path == "/v1/generate":
                await self._handle_generate(reader, writer, body)
            else:
                await self._respond_json(writer, 404,
                                         {"error": f"no route {path}"})
        finally:
            try:
                if writer.can_write_eof():
                    writer.write_eof()
            except (ConnectionError, OSError):
                pass
            writer.close()

    async def _handle_generate(self, reader: asyncio.StreamReader,
                               writer: asyncio.StreamWriter,
                               body: bytes) -> None:
        try:
            payload = json.loads(body or b"{}")
            prompt = payload["prompt"]
            max_new = int(payload.get("max_new", 16))
        except (json.JSONDecodeError, KeyError, TypeError, ValueError):
            await self._respond_json(writer, 400, {"error": "bad request"})
            return
        try:
            h = self.submit(np.asarray(prompt, np.int32), max_new,
                            slo=payload.get("slo"),
                            deadline_s=payload.get("deadline_s"),
                            tier=payload.get("tier"))
        except QueueFull:
            await self._respond_json(writer, 429,
                                     {"error": "overloaded, retry later"})
            return
        except (RequestRejected, ValueError) as e:
            await self._respond_json(writer, 400, {"error": str(e)})
            return
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-store\r\n"
            b"Connection: close\r\n\r\n")
        accepted = {"rid": h.rid, "slo": h.slo.name}
        if h.slo.tier is not None:
            accepted["tier"] = h.slo.tier
        writer.write(_sse("accepted", accepted))
        # disconnect watch: SSE clients send nothing after the request,
        # so any read completion (b"" on EOF or stray bytes) means the
        # peer went away and the generation should be cancelled
        monitor = asyncio.ensure_future(reader.read(1))
        try:
            while True:
                getter = asyncio.ensure_future(h.next_event())
                await asyncio.wait({getter, monitor},
                                   return_when=asyncio.FIRST_COMPLETED)
                if monitor.done():
                    # peer gone: cancel even if tokens are still queued
                    # — nobody is listening, don't wait for drain to fail
                    if not getter.done():
                        getter.cancel()
                    h.cancel()
                    break
                kind, value = await getter
                if kind == _EV_TOKEN:
                    try:
                        writer.write(_sse(None, {"token": value}))
                        await writer.drain()
                    except (ConnectionError, OSError):
                        h.cancel()
                        break
                else:  # end-of-stream
                    name = "done" if h.state == FINISHED else "error"
                    try:
                        writer.write(_sse(name, {
                            "reason": value,
                            "tokens": len(h.tokens),
                            "slo_met": h.slo_met,
                        }))
                        await writer.drain()
                    except (ConnectionError, OSError):
                        pass
                    break
        finally:
            monitor.cancel()

    async def _respond(self, writer: asyncio.StreamWriter, status: int,
                       body: bytes, ctype: str) -> None:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  429: "Too Many Requests"}.get(status, "")
        writer.write(
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n".encode() + body)
        try:
            await writer.drain()
        except (ConnectionError, OSError):
            pass

    async def _respond_json(self, writer: asyncio.StreamWriter,
                            status: int, obj: Dict[str, Any]) -> None:
        await self._respond(writer, status, json.dumps(obj).encode(),
                            "application/json")


def _sse(event: Optional[str], data: Dict[str, Any]) -> bytes:
    """One server-sent event frame."""
    head = f"event: {event}\n" if event else ""
    return f"{head}data: {json.dumps(data)}\n\n".encode()


async def _read_request(
    reader: asyncio.StreamReader,
) -> Tuple[str, str, Dict[str, str], bytes]:
    """Minimal HTTP/1.1 request parse: request line, headers, body by
    Content-Length (no chunked encoding — our clients never send it)."""
    line = await reader.readline()
    if not line.strip():
        raise ValueError("empty request")
    parts = line.decode("latin-1").split()
    if len(parts) < 3:
        raise ValueError(f"bad request line {line!r}")
    method, path = parts[0].upper(), parts[1]
    headers: Dict[str, str] = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    n = int(headers.get("content-length", "0") or "0")
    body = await reader.readexactly(n) if n else b""
    return method, path, headers, body


def _percentile(xs: List[float], p: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), p)) if xs else 0.0
