"""SLO classes for the serving frontend.

An SLO class bundles the two knobs the stack already understands —
scheduler priority and a time-to-first-token deadline — under a name a
client can put on the wire.  The mapping is deliberately small and
fixed (three classes) so every per-class metric label stays bounded
(obs rule: label values come from closed sets, never from requests).

* ``interactive`` — chat turns a human is watching.  Highest priority,
  tight TTFT deadline; requests that cannot start in time are *shed*
  at the admission boundary rather than served late.
* ``standard`` — default API traffic.  Mid priority, loose deadline.
* ``batch`` — offline/eval traffic.  Lowest priority, no deadline;
  batch requests absorb whatever capacity interactive traffic leaves
  and are preempted first under pool pressure (the scheduler's
  strictly-worse victim rule keys on priority).

Deadlines are *TTFT* deadlines, matching how the frontend sheds: a
request that has produced even one token is never shed (its deadline
already resolved, met or missed), so the deadline only gates admission
and queueing — see ``ServingFrontend._shed_expired``.

``resolve_slo`` accepts a name or an ``SLOClass`` so library callers
can pass custom classes programmatically; the HTTP surface only admits
the named ones.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Union

__all__ = ["SLOClass", "SLO_CLASSES", "DEFAULT_SLO", "resolve_slo"]


@dataclass(frozen=True)
class SLOClass:
    name: str
    priority: int
    ttft_deadline_s: Optional[float]  # None = no deadline (never shed)
    # per-request sparsity tier (griffin.TIERS): fraction of FF experts
    # kept.  None = the server's default (quality knob rides the same
    # wire object as the latency knobs, so a class can pin e.g. batch
    # traffic to a cheap tier)
    tier: Optional[float] = None

    def __post_init__(self):
        if self.ttft_deadline_s is not None and self.ttft_deadline_s <= 0:
            raise ValueError(f"ttft_deadline_s must be > 0, got {self.ttft_deadline_s}")
        if self.tier is not None:
            from repro_torch.core.griffin import resolve_tier

            object.__setattr__(self, "tier", resolve_tier(self.tier))


SLO_CLASSES: Dict[str, SLOClass] = {
    c.name: c
    for c in (
        SLOClass("interactive", priority=2, ttft_deadline_s=0.5),
        SLOClass("standard", priority=1, ttft_deadline_s=2.0),
        SLOClass("batch", priority=0, ttft_deadline_s=None),
    )
}

DEFAULT_SLO = "standard"


def resolve_slo(slo: Union[str, SLOClass, None]) -> SLOClass:
    """Name or instance -> ``SLOClass``; ``None`` -> the default class."""
    if slo is None:
        return SLO_CLASSES[DEFAULT_SLO]
    if isinstance(slo, SLOClass):
        return slo
    try:
        return SLO_CLASSES[slo]
    except KeyError:
        raise ValueError(
            f"unknown SLO class {slo!r} (have {sorted(SLO_CLASSES)})"
        ) from None
