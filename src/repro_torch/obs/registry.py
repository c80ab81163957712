"""Bounded metric registry: counters, gauges, fixed-bucket streaming
histograms; Prometheus text exposition and a JSON snapshot.

The histograms are the load-bearing piece: ``ServingMetrics`` used to
append one float per tick to four Python lists, so a long-lived server
grew host memory linearly with uptime.  A ``Histogram`` here keeps a
fixed bucket vector plus exact running ``sum``/``count``/``min``/``max``
— means and totals derived from it are *numerically identical* to the
old list-based ``np.mean``/``np.sum`` (same additions, same order), so
``ServingMetrics.summary()`` is unchanged as a compatibility view.
Quantiles are the only approximation: estimated by linear interpolation
inside the owning bucket, so the error is bounded by the bucket width
(``tests/test_obs.py`` checks agreement against exact percentiles on a
recorded drain).

Metric identity is ``(name, sorted label items)``; re-requesting an
existing metric returns the same object (get-or-create), which is how
call sites stay decoupled from who registered first.  Label
cardinality is the caller's contract: label values must come from a
bounded set (layer names, shard ids — never request ids).
"""
from __future__ import annotations

import json
import math
import re
from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "linear_buckets",
    "exp_buckets",
    "validate_prometheus_text",
]

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, str]]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))


def _label_str(labels: LabelKey) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    return repr(float(v))


def linear_buckets(start: float, stop: float, count: int) -> Tuple[float, ...]:
    """``count`` evenly spaced upper bounds over [start, stop]."""
    if count < 1:
        raise ValueError("count must be >= 1")
    if count == 1:
        return (float(stop),)
    step = (stop - start) / (count - 1)
    return tuple(float(start + i * step) for i in range(count))


def exp_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """``count`` geometrically spaced upper bounds from ``start``."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(float(start * factor ** i) for i in range(count))


@dataclass
class Counter:
    """Monotone count.  ``set`` exists only for exposition sync from an
    external authoritative count (e.g. ``ServingMetrics`` scalars)."""
    name: str
    labels: LabelKey = ()
    help: str = ""
    value: float = 0.0

    kind = "counter"

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up")
        self.value += v

    def set(self, v: float) -> None:
        self.value = float(v)


@dataclass
class Gauge:
    name: str
    labels: LabelKey = ()
    help: str = ""
    value: float = 0.0

    kind = "gauge"

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v


@dataclass
class Histogram:
    """Streaming histogram over fixed upper-bound buckets.

    ``bounds`` are ascending upper edges; an implicit +Inf bucket
    catches overflow.  ``observe`` is O(log buckets) and allocates
    nothing.  ``sum``/``count``/``vmin``/``vmax`` are exact.
    """
    name: str
    bounds: Tuple[float, ...] = ()
    labels: LabelKey = ()
    help: str = ""
    counts: List[int] = field(default_factory=list)
    sum: float = 0.0
    count: int = 0
    vmin: float = math.inf
    vmax: float = -math.inf

    kind = "histogram"

    def __post_init__(self) -> None:
        if not self.bounds:
            raise ValueError(f"histogram {self.name}: no buckets")
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(f"histogram {self.name}: bounds must ascend")
        if not self.counts:
            self.counts = [0] * (len(self.bounds) + 1)

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Quantile estimate: locate the owning bucket by cumulative
        count, interpolate linearly inside it.  Bucket edges are clamped
        to the observed [vmin, vmax] so the estimate never leaves the
        data range (matters for the first and +Inf buckets)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q in [0, 1]")
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0.0
        for i, c in enumerate(self.counts):
            if cum + c >= target and c > 0:
                lo = self.vmin if i == 0 else self.bounds[i - 1]
                hi = self.vmax if i == len(self.bounds) else self.bounds[i]
                lo = max(lo, self.vmin)
                hi = min(hi, self.vmax)
                if hi <= lo:
                    return float(lo)
                frac = (target - cum) / c
                return float(lo + frac * (hi - lo))
            cum += c
        return float(self.vmax)


class Registry:
    """Get-or-create metric registry with Prometheus/JSON export."""

    def __init__(self) -> None:
        self._metrics: Dict[Tuple[str, LabelKey], object] = {}
        self._order: List[Tuple[str, LabelKey]] = []

    def _get(self, cls, name: str, labels: Optional[Dict[str, str]],
             help: str, **kwargs):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name=name, labels=key[1], help=help, **kwargs)
            self._metrics[key] = m
            self._order.append(key)
        elif not isinstance(m, cls):
            raise TypeError(f"{name}: registered as {type(m).__name__}, "
                            f"requested {cls.__name__}")
        return m

    def counter(self, name: str, labels: Optional[Dict[str, str]] = None,
                help: str = "") -> Counter:
        return self._get(Counter, name, labels, help)

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None,
              help: str = "") -> Gauge:
        return self._get(Gauge, name, labels, help)

    def histogram(self, name: str, buckets: Sequence[float],
                  labels: Optional[Dict[str, str]] = None,
                  help: str = "") -> Histogram:
        h = self._get(Histogram, name, labels, help,
                      bounds=tuple(float(b) for b in buckets))
        if tuple(h.bounds) != tuple(float(b) for b in buckets):
            raise ValueError(f"{name}: conflicting bucket bounds")
        return h

    def __iter__(self) -> Iterable[object]:
        return iter(self._metrics[k] for k in self._order)

    def __len__(self) -> int:
        return len(self._metrics)

    # -- export ------------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """JSON-serializable snapshot of every metric."""
        out: List[Dict[str, object]] = []
        for m in self:
            d: Dict[str, object] = {
                "name": m.name, "type": m.kind,
                "labels": dict(m.labels),
            }
            if isinstance(m, Histogram):
                d.update(
                    sum=m.sum, count=m.count, mean=m.mean,
                    min=m.vmin if m.count else None,
                    max=m.vmax if m.count else None,
                    buckets=[{"le": _fmt(b), "count": c} for b, c in
                             zip(list(m.bounds) + [math.inf],
                                 _cumulative(m.counts))],
                    p50=m.quantile(0.5), p95=m.quantile(0.95),
                )
            else:
                d["value"] = m.value
            out.append(d)
        return {"metrics": out}

    def snapshot_json(self, **dump_kwargs) -> str:
        dump_kwargs.setdefault("indent", 2)
        return json.dumps(self.snapshot(), **dump_kwargs)

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines: List[str] = []
        seen_type: set = set()
        for m in self:
            if m.name not in seen_type:
                seen_type.add(m.name)
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.kind}")
            ls = _label_str(m.labels)
            if isinstance(m, Histogram):
                cum = _cumulative(m.counts)
                for b, c in zip(list(m.bounds) + [math.inf], cum):
                    bl = dict(m.labels)
                    bl["le"] = _fmt(b)
                    lines.append(f"{m.name}_bucket{_label_str(_label_key(bl))} {c}")
                lines.append(f"{m.name}_sum{ls} {_fmt(m.sum)}")
                lines.append(f"{m.name}_count{ls} {m.count}")
            else:
                lines.append(f"{m.name}{ls} {_fmt(m.value)}")
        return "\n".join(lines) + "\n"


def _cumulative(counts: Sequence[int]) -> List[int]:
    out, run = [], 0
    for c in counts:
        run += c
        out.append(run)
    return out


# -- validation (shared by tests, benchmarks, scripts/check_trace.py) ------

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^}]*\})?"
    r"\s+(?P<value>[^\s]+)(\s+\d+)?$")


def validate_prometheus_text(text: str) -> List[str]:
    """Structural checks on exposition text; returns error strings
    (empty list = valid).  Checks sample syntax, TYPE declarations,
    histogram completeness (+Inf bucket, cumulative monotonicity,
    ``_count`` equal to the +Inf bucket)."""
    errors: List[str] = []
    types: Dict[str, str] = {}
    hist: Dict[str, Dict[str, object]] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                errors.append(f"line {ln}: malformed TYPE: {line!r}")
            else:
                types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            errors.append(f"line {ln}: unparseable sample: {line!r}")
            continue
        name, value = m.group("name"), m.group("value")
        try:
            float(value.replace("+Inf", "inf").replace("-Inf", "-inf")
                  .replace("NaN", "nan"))
        except ValueError:
            errors.append(f"line {ln}: bad value {value!r}")
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in types \
                    and types[name[: -len(suffix)]] == "histogram":
                base = name[: -len(suffix)]
                break
        if base not in types and name not in types:
            errors.append(f"line {ln}: sample {name!r} has no TYPE")
        if base in types and types[base] == "histogram":
            series = hist.setdefault(
                _strip_le(m.group("labels") or "") + " " + base,
                {"buckets": [], "count": None})
            if name.endswith("_bucket"):
                le = _extract_le(m.group("labels") or "")
                if le is None:
                    errors.append(f"line {ln}: bucket without le label")
                else:
                    series["buckets"].append((le, float(value)))
            elif name.endswith("_count"):
                series["count"] = float(value)
    for key, series in hist.items():
        buckets = series["buckets"]
        if not buckets:
            continue
        if buckets[-1][0] != math.inf:
            errors.append(f"{key}: histogram missing +Inf bucket")
        counts = [c for _, c in buckets]
        if counts != sorted(counts):
            errors.append(f"{key}: bucket counts not cumulative")
        if series["count"] is not None and buckets[-1][0] == math.inf \
                and series["count"] != buckets[-1][1]:
            errors.append(f"{key}: _count != +Inf bucket")
    return errors


def _extract_le(labelstr: str) -> Optional[float]:
    m = re.search(r'le="([^"]*)"', labelstr)
    if m is None:
        return None
    v = m.group(1)
    try:
        return math.inf if v == "+Inf" else float(v)
    except ValueError:
        return None


def _strip_le(labelstr: str) -> str:
    return re.sub(r'le="[^"]*",?', "", labelstr)
