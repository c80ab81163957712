"""Chrome/Perfetto trace export for ``obs.trace.Tracer``.

Produces the JSON object format (``{"traceEvents": [...]}``) that
``chrome://tracing`` and https://ui.perfetto.dev load directly.  The
exporter prepends process/thread metadata events and sorts by
timestamp; the recorder appends X events on span *exit*, so raw buffer
order is children-before-parents and viewers want ``ts`` order.

``validate_chrome_trace`` is the schema/invariant checker that
``write_trace`` (the launcher's ``--trace-out``) and the tests run:
beyond per-event field checks it verifies
the two structural invariants a *correct* recorder must maintain —
synchronous X spans on one thread nest strictly (no partial overlap),
and every async request chain is ``b`` first, ``e`` last, instants in
between.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from repro_torch.obs.trace import Tracer

__all__ = ["chrome_trace", "write_trace", "validate_chrome_trace"]

_PHASES = frozenset("XBEibnesMC")

_THREAD_NAMES = {1: "serving step", 2: "gauges"}


def chrome_trace(tracer: Tracer,
                 meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Build the loadable trace object from a tracer's buffer."""
    events: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0, "ts": 0,
         "args": {"name": "repro_torch.serving"}},
    ]
    tids = {ev.get("tid") for ev in tracer.events}
    for tid in sorted(t for t in tids if t is not None):
        events.append({"ph": "M", "name": "thread_name", "pid": 1,
                       "tid": tid, "ts": 0,
                       "args": {"name": _THREAD_NAMES.get(tid, f"tid{tid}")}})
    events.extend(sorted(tracer.events, key=lambda e: e["ts"]))
    other: Dict[str, Any] = {"dropped_events": tracer.dropped}
    if meta:
        other.update(meta)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


def write_trace(tracer: Tracer, path: Union[str, Path],
                meta: Optional[Dict[str, Any]] = None) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    obj = chrome_trace(tracer, meta=meta)
    errors = validate_chrome_trace(obj)
    if errors:  # never write an artifact the viewer would reject
        raise ValueError(f"refusing to write invalid trace: {errors[:3]}")
    path.write_text(json.dumps(obj))
    return path


# -- validation ------------------------------------------------------------

def validate_chrome_trace(obj: Any) -> List[str]:
    """Schema + invariant checks; returns error strings (empty = valid)."""
    errors: List[str] = []
    if not isinstance(obj, dict) or not isinstance(
            obj.get("traceEvents"), list):
        return ["top level must be {'traceEvents': [...]}"]
    sync: Dict[Any, List[Dict[str, Any]]] = {}
    asyncs: Dict[Any, List[Dict[str, Any]]] = {}
    for i, ev in enumerate(obj["traceEvents"]):
        where = f"event {i}"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES:
            errors.append(f"{where}: bad ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) and ph != "E":
            errors.append(f"{where}: missing name")
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int):
                errors.append(f"{where}: missing/non-int {k}")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or math.isnan(ts) or ts < 0:
            errors.append(f"{where}: bad ts {ts!r}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: X event bad dur {dur!r}")
            else:
                sync.setdefault((ev.get("pid"), ev.get("tid")),
                                []).append(ev)
        elif ph in "bne":
            if "id" not in ev:
                errors.append(f"{where}: async event missing id")
            else:
                asyncs.setdefault((ev.get("cat"), ev["id"]),
                                  []).append(ev)
    errors.extend(_check_nesting(sync))
    errors.extend(_check_async(asyncs))
    return errors


def _check_nesting(sync: Dict[Any, List[Dict[str, Any]]]) -> List[str]:
    """X spans on one (pid, tid) must nest: for any two overlapping
    spans, one fully contains the other."""
    errors: List[str] = []
    for (pid, tid), evs in sync.items():
        # parents first at equal start
        evs = sorted(evs, key=lambda e: (e["ts"], -e["dur"]))
        stack: List[Dict[str, Any]] = []  # open enclosing spans
        for ev in evs:
            start, end = ev["ts"], ev["ts"] + ev["dur"]
            while stack and start >= stack[-1]["ts"] + stack[-1]["dur"] - 1e-9:
                stack.pop()
            if stack:
                p_end = stack[-1]["ts"] + stack[-1]["dur"]
                if end > p_end + 1e-6:  # µs slack for float round-trip
                    errors.append(
                        f"tid {tid}: span {ev.get('name')!r} "
                        f"[{start:.3f}, {end:.3f}] overlaps "
                        f"{stack[-1].get('name')!r} ending {p_end:.3f}")
                    continue
            stack.append(ev)
    return errors


def _check_async(asyncs: Dict[Any, List[Dict[str, Any]]]) -> List[str]:
    """Each (cat, id) chain: exactly one b, at most one e; b at the
    earliest ts, e at the latest; instants inside the window."""
    errors: List[str] = []
    for (cat, aid), evs in asyncs.items():
        key = f"async (cat={cat!r}, id={aid!r})"
        begins = [e for e in evs if e["ph"] == "b"]
        ends = [e for e in evs if e["ph"] == "e"]
        if len(begins) != 1:
            errors.append(f"{key}: {len(begins)} begin events (want 1)")
            continue
        if len(ends) > 1:
            errors.append(f"{key}: {len(ends)} end events (want <= 1)")
            continue
        b_ts = begins[0]["ts"]
        e_ts = ends[0]["ts"] if ends else math.inf
        if e_ts < b_ts:
            errors.append(f"{key}: end ts {e_ts} before begin ts {b_ts}")
        for e in evs:
            if e["ph"] == "n" and not (b_ts <= e["ts"] <= e_ts):
                errors.append(
                    f"{key}: instant {e.get('name')!r} at ts {e['ts']} "
                    f"outside [{b_ts}, {e_ts}]")
    return errors
