"""Serving observability (the reference's ``obs`` package): span
tracing (``trace``) and its Chrome/Perfetto export (``export``), bounded
metrics (``registry``), straggler telemetry (``stragglers``), and live
flocking telemetry (``flocking``: Jaccard / angular drift of each
request's GRIFFIN selection, fed by ``PagedServer``'s probe)."""
from repro_torch.obs.registry import Registry, exp_buckets, linear_buckets
from repro_torch.obs.trace import NULL_TRACER, Tracer

__all__ = ["Registry", "Tracer", "NULL_TRACER", "exp_buckets",
           "linear_buckets"]
