"""Per-tick step-time telemetry, wired into the seed's dormant
``runtime.straggler.StragglerDetector``.

Two detection layers with different horizons:

* **Tick-level** (this module's rolling window): a single tick whose
  duration exceeds ``threshold`` x the rolling median of recent ticks
  increments the ``serving_straggler_ticks`` counter and logs a
  warning.  This catches one-off stalls — a recompile, an allocator
  scramble, a COW burst — that an EWMA would smooth away.
* **Host-level** (``StragglerDetector``): per-shard durations feed the
  detector's per-host EWMAs; hosts flagged for ``patience`` consecutive
  windows surface on the ``serving_straggler_hosts`` gauge.  Under
  single-process tensor parallelism the steps are synchronous SPMD, so
  the host wall time is attributed to every shard — an upper bound per
  shard; on a real multi-host deployment each process records its own
  shard's time and the median comparison becomes meaningful.

The current tick is compared against the median *before* being added
to the window, so a spike cannot dilute its own baseline.  The counter
counts every flagged tick; the *log line* is throttled to one per
``log_every`` flags — mixed workloads flag systematically (a prefill
chunk is legitimately several decode ticks long), and per-tick warnings
would drown the serving log.
"""
from __future__ import annotations

import logging
from collections import deque
from statistics import median
from typing import Dict, Optional

from repro_torch.obs.registry import Registry, exp_buckets
from repro_torch.runtime.straggler import StragglerDetector

__all__ = ["StepTimeMonitor"]

logger = logging.getLogger(__name__)

# 10 µs .. ~84 s, x2 per bucket: covers tiny-CPU ticks through real
# accelerator prefill chunks in 24 buckets.
TICK_BUCKETS = exp_buckets(1e-5, 2.0, 24)


class StepTimeMonitor:
    """Feed per-tick (and optionally per-shard) durations; exports a
    tick-duration histogram, a straggler-tick counter and a flagged-host
    gauge into ``registry``."""

    def __init__(self, registry: Registry, *, window: int = 64,
                 threshold: float = 3.0, min_ticks: int = 8,
                 log_every: int = 32,
                 detector: Optional[StragglerDetector] = None):
        self.detector = detector if detector is not None else StragglerDetector()
        self.threshold = threshold
        self.min_ticks = min_ticks
        self.log_every = max(1, log_every)
        self._suppressed = 0
        self._window: deque = deque(maxlen=window)
        self.tick_seconds = registry.histogram(
            "serving_tick_seconds", buckets=TICK_BUCKETS,
            help="Wall time of one PagedServer.step() tick")
        self.straggler_ticks = registry.counter(
            "serving_straggler_ticks",
            help="Ticks exceeding threshold x rolling median")
        self.straggler_hosts = registry.gauge(
            "serving_straggler_hosts",
            help="Hosts currently flagged by the EWMA straggler detector")

    def on_tick(self, dur_s: float,
                shard_times: Optional[Dict[int, float]] = None) -> bool:
        """Record one tick; returns True when the tick was flagged as a
        straggler against the rolling median."""
        self.tick_seconds.observe(dur_s)
        flagged_tick = False
        if len(self._window) >= self.min_ticks:
            med = median(self._window)
            if med > 0 and dur_s > self.threshold * med:
                flagged_tick = True
                self.straggler_ticks.inc()
                if self._suppressed == 0:
                    logger.warning(
                        "straggler tick: %.2f ms > %.1fx rolling median "
                        "%.2f ms (next %d flags logged at debug)",
                        dur_s * 1e3, self.threshold, med * 1e3,
                        self.log_every - 1)
                else:
                    logger.debug(
                        "straggler tick: %.2f ms > %.1fx rolling median "
                        "%.2f ms", dur_s * 1e3, self.threshold, med * 1e3)
                self._suppressed = (self._suppressed + 1) % self.log_every
        self._window.append(dur_s)
        for host, t in (shard_times or {0: dur_s}).items():
            self.detector.record(host, t)
        flagged_hosts = self.detector.evaluate()
        self.straggler_hosts.set(len(flagged_hosts))
        if flagged_hosts:
            logger.warning("straggler hosts flagged: %s",
                           sorted(flagged_hosts))
        return flagged_tick
