"""Injectable time for the serving frontend and its tests.

Every time read in the serving stack goes through a zero-argument
callable (``ServingMetrics.clock``, ``Tracer.clock``, and the
frontend's ``clock``) — production binds ``time.perf_counter``, tests
bind a ``FakeClock`` and advance it explicitly.  That one seam is what
makes the frontend's concurrency tests deterministic: admission,
deadline expiry, shedding and cancellation-latency numbers are pure
functions of (submitted work, tick order, explicit ``advance`` calls),
never of host scheduling jitter, so interleavings reproduce
byte-for-byte in CI with **zero wall-clock sleeps** (DESIGN.md
section 13).

``FakeClock`` is deliberately manual: nothing advances it implicitly,
not even ``ServingFrontend.tick`` — a test that wants time to pass says
so.  ``advance`` rejects negative steps because every consumer
(metrics wall window, deadline comparisons, trace timestamps) assumes
monotone time.
"""
from __future__ import annotations

__all__ = ["FakeClock"]


class FakeClock:
    """Manually advanced virtual clock; call it like ``time.perf_counter``."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        """Move time forward by ``dt`` seconds; returns the new time."""
        if dt < 0:
            raise ValueError(f"time only advances (dt={dt})")
        self.now += float(dt)
        return self.now

    def advance_to(self, t: float) -> float:
        """Jump to absolute time ``t`` (no-op when ``t`` is in the past
        — arrival-driven loops jump to the next event unconditionally)."""
        self.now = max(self.now, float(t))
        return self.now
