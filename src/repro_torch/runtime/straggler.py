"""Straggler detection: per-host step-time EWMAs vs the fleet median.

At multi-pod scale slow hosts (thermal throttling, failing HBM, noisy
neighbors) stretch every synchronous step.  The detector keeps an EWMA
of per-host step durations, flags hosts exceeding ``threshold`` x the
fleet median for ``patience`` consecutive windows, and hands the flagged
set to the elastic planner (``repro.runtime.elastic``) which decides
whether to evict + re-mesh.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Set


@dataclass
class StragglerDetector:
    alpha: float = 0.2  # EWMA smoothing
    threshold: float = 1.5  # x median
    patience: int = 3  # consecutive flagged windows before reporting
    ewma: Dict[int, float] = field(default_factory=dict)
    strikes: Dict[int, int] = field(default_factory=lambda: defaultdict(int))

    def record(self, host: int, step_time_s: float) -> None:
        prev = self.ewma.get(host)
        self.ewma[host] = (
            step_time_s if prev is None
            else self.alpha * step_time_s + (1 - self.alpha) * prev
        )

    def _median(self) -> float:
        vals = sorted(self.ewma.values())
        n = len(vals)
        if n == 0:
            return 0.0
        return vals[n // 2] if n % 2 else 0.5 * (vals[n // 2 - 1] + vals[n // 2])

    def evaluate(self) -> Set[int]:
        """Update strike counts; return hosts flagged >= patience times."""
        med = self._median()
        flagged = set()
        if med <= 0:
            return flagged
        for host, t in self.ewma.items():
            if t > self.threshold * med:
                self.strikes[host] += 1
            else:
                self.strikes[host] = 0
            if self.strikes[host] >= self.patience:
                flagged.add(host)
        return flagged
