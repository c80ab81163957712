"""Model-free serving engine for frontend/SLO tests.

``SimServer`` satisfies the engine contract ``ServingFrontend``
depends on — ``sched`` / ``n_slots`` / ``submit`` / ``step`` /
``cancel`` — while running the **real** ``Scheduler`` over the **real**
``BlockAllocator``, with the device work replaced by a deterministic
token function.  That keeps every property the frontend tests care
about (admission order, EDF within a class, preemption, page
conservation, cancel/shed paths) exactly the production logic, minus
the model, its weights and the device — which is what lets the
frontend tests replay whole traces in tier-1 time.

The token function is a pure hash of (rid, position), so any two runs
that make the same scheduling decisions produce identical streams —
the determinism anchor the property tests assert against.

What SimServer does **not** model: speculative drafting, prefix-cache
COW device copies, GRIFFIN expert selection (all exercised against the
real ``PagedServer`` in ``tests/test_torch_frontend.py``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.paged import PagedConfig
from repro_torch.serving.scheduler import Scheduler

__all__ = ["SimServer", "sim_token"]


def sim_token(rid: int, pos: int) -> int:
    """Deterministic stand-in logits argmax for (request, position)."""
    return (rid * 7919 + pos * 104729 + 17) % 50021


class SimServer:
    """Host-only engine: real scheduling, hashed tokens, no device."""

    def __init__(self, *, page_size: int = 4, num_pages: int = 64,
                 max_pages_per_request: int = 16, n_slots: int = 4,
                 prefill_chunk: int = 8,
                 metrics: Optional[ServingMetrics] = None,
                 prefix_cache: bool = False):
        self.pcfg = PagedConfig(page_size=page_size, num_pages=num_pages,
                                max_pages_per_request=max_pages_per_request)
        self.n_slots = n_slots
        self.sched = Scheduler(self.pcfg, n_slots,
                               prefill_chunk=prefill_chunk,
                               metrics=metrics, prefix_cache=prefix_cache)
        self._next_rid = 0

    @property
    def metrics(self) -> ServingMetrics:
        return self.sched.metrics

    def submit(self, prompt: np.ndarray, max_new: int,
               rid: Optional[int] = None, priority: int = 0,
               deadline: Optional[float] = None) -> int:
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid + 1)
        self.sched.submit(prompt, max_new, rid, priority, deadline=deadline)
        return rid

    def step(self) -> bool:
        """One tick, mirroring ``PagedServer.step``'s scheduler driving
        (plan -> execute -> completion callbacks -> step gauges) with
        the device work elided."""
        plan = self.sched.plan_step()
        if plan.prefill is not None:
            w = plan.prefill
            first = None
            if w.is_last and not w.req.generated:
                first = sim_token(w.req.rid, 0)
            self.sched.finish_prefill_chunk(w, first)
        for req in plan.decode:
            self.sched.finish_decode_token(
                req, sim_token(req.rid, len(req.generated)))
        self.metrics.on_step(self.sched.pool_in_use_frac(),
                             len(plan.decode),
                             shared_pages=self.sched.alloc.num_shared)
        return self.sched.has_work

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        return self.sched.cancel(rid, reason=reason)

    def drain(self) -> Dict[int, List[int]]:
        while self.step():
            pass
        return {rid: r.generated for rid, r in self.sched.finished.items()
                if not r.aborted}
