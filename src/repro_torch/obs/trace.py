"""Structured span recorder for the serving stack.

Two span families, matching how a drain decomposes:

* **Tick spans** — synchronous, nested, recorded as Chrome "complete"
  (``ph: "X"``) events: one ``tick`` span per ``PagedServer.step()``
  with ``plan`` / ``cow_copy`` / ``prefill_chunk`` / ``decode`` /
  ``spec_round`` / ``flocking_probe`` children.  ``plan`` is pure
  host-side scheduling; the dispatch children block on device results,
  so their duration is host+device wall time — the breakdown the
  "why was this drain slow" question needs.
* **Request spans** — asynchronous (``ph: "b"/"n"/"e"``), keyed by
  request id, spanning submit to finish with instants for prefill
  chunks, first token, spec rounds, preemptions, COW forks and prefix
  hits.  ``ServingMetrics`` emits these from its lifecycle callbacks
  using the *same clock read* it records in the timeline, so the trace
  reconciles exactly with ``summary()``.

Timestamps: the recorder stores microseconds relative to the first
event (Chrome traces want small positive ``ts``).  The clock is
injectable — tests drive virtual time and get byte-identical traces.

Disabled path: ``NULL_TRACER`` is a singleton whose ``span()`` returns
a shared no-op context manager and whose event buffer is an immutable
empty tuple — zero allocations per call, nothing grows per tick.  Code
holds a ``Tracer``-shaped object unconditionally and never branches.

The buffer is bounded (``max_events``); overflow increments ``dropped``
instead of growing — a tracer left on forever degrades, it never OOMs.
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Tracer", "NullTracer", "NULL_TRACER"]

_PID = 1  # single-process serving; one logical pid in the trace
_TID_STEP = 1  # tick/phase spans
_TID_OBS = 2  # counter samples


class _Span:
    """Context manager recording one complete ("X") event on exit."""
    __slots__ = ("_tr", "name", "cat", "args", "_t0")

    def __init__(self, tr: "Tracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]]):
        self._tr = tr
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self) -> "_Span":
        self._t0 = self._tr.clock()
        # anchor the epoch at entry: the X event is recorded on *exit*,
        # and anchoring there would give the first (outermost) span a
        # negative ts relative to a child that exited earlier
        if self._tr._epoch is None:
            self._tr._epoch = self._t0
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tr
        t1 = tr.clock()
        ev = {"ph": "X", "name": self.name, "cat": self.cat,
              "pid": _PID, "tid": _TID_STEP,
              "ts": tr._us(self._t0), "dur": max(0.0, (t1 - self._t0) * 1e6)}
        if self.args:
            ev["args"] = self.args
        tr._push(ev)
        return False


class Tracer:
    """Bounded in-memory event recorder (Chrome trace event model)."""

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 max_events: int = 1_000_000,
                 annotate_profiler: bool = False):
        self.clock = clock
        self.max_events = max_events
        self.annotate_profiler = annotate_profiler
        self.events: List[Dict[str, Any]] = []
        self.dropped = 0
        self._epoch: Optional[float] = None

    # -- internals ---------------------------------------------------------
    def _us(self, t: Optional[float] = None) -> float:
        """Clock seconds -> microseconds since the first event."""
        t = self.clock() if t is None else t
        if self._epoch is None:
            self._epoch = t
        return (t - self._epoch) * 1e6

    def _push(self, ev: Dict[str, Any]) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    # -- synchronous (tick) spans ------------------------------------------
    def span(self, name: str, cat: str = "step", **args: Any):
        """``with tracer.span("plan"): ...`` — one nested X event."""
        return _Span(self, name, cat, args or None)

    def instant(self, name: str, cat: str = "step",
                ts: Optional[float] = None, **args: Any) -> None:
        ev = {"ph": "i", "name": name, "cat": cat, "s": "t",
              "pid": _PID, "tid": _TID_STEP, "ts": self._us(ts)}
        if args:
            ev["args"] = args
        self._push(ev)

    def counter(self, name: str, ts: Optional[float] = None,
                **values: float) -> None:
        """One multi-series counter sample (stacked chart in the UI)."""
        self._push({"ph": "C", "name": name, "cat": "gauge",
                    "pid": _PID, "tid": _TID_OBS, "ts": self._us(ts),
                    "args": values})

    # -- asynchronous (request) spans --------------------------------------
    # Keyed by (cat, id): one b ... n* ... e chain per request id.
    def abegin(self, aid: int, name: str, cat: str = "request",
               ts: Optional[float] = None, **args: Any) -> None:
        self._async("b", aid, name, cat, ts, args)

    def ainstant(self, aid: int, name: str, cat: str = "request",
                 ts: Optional[float] = None, **args: Any) -> None:
        self._async("n", aid, name, cat, ts, args)

    def aend(self, aid: int, name: str, cat: str = "request",
             ts: Optional[float] = None, **args: Any) -> None:
        self._async("e", aid, name, cat, ts, args)

    def _async(self, ph: str, aid: int, name: str, cat: str,
               ts: Optional[float], args: Dict[str, Any]) -> None:
        ev = {"ph": ph, "name": name, "cat": cat, "id": int(aid),
              "pid": _PID, "tid": _TID_STEP, "ts": self._us(ts)}
        if args:
            ev["args"] = args
        self._push(ev)

    # -- optional torch.profiler bridge ------------------------------------
    def annotation(self, name: str):
        """``record_function`` context around a model step, visible in
        ``torch.profiler`` timelines; a no-op unless
        ``annotate_profiler``."""
        if not self.annotate_profiler:
            return nullcontext()
        import torch.profiler
        return torch.profiler.record_function(name)


class NullTracer:
    """Disabled tracer: every hook is a no-op, nothing allocates.

    ``events`` is an immutable empty tuple so accidental appends fail
    loudly and ``len()`` stays 0; ``span()`` returns one shared
    ``nullcontext`` instance.
    """

    enabled = False
    events: tuple = ()
    dropped = 0

    _NULL_CTX = nullcontext()

    def span(self, name: str, cat: str = "step", **args: Any):
        return self._NULL_CTX

    def instant(self, *a: Any, **k: Any) -> None:
        pass

    def counter(self, *a: Any, **k: Any) -> None:
        pass

    def abegin(self, *a: Any, **k: Any) -> None:
        pass

    def ainstant(self, *a: Any, **k: Any) -> None:
        pass

    def aend(self, *a: Any, **k: Any) -> None:
        pass

    def annotation(self, name: str):
        return self._NULL_CTX


NULL_TRACER = NullTracer()
