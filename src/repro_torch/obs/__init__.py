"""Serving observability: span tracing and bounded metrics (copies of
the reference's host-side ``obs`` modules)."""
from repro_torch.obs.registry import Registry, exp_buckets, linear_buckets
from repro_torch.obs.trace import NULL_TRACER, Tracer

__all__ = ["Registry", "Tracer", "NULL_TRACER", "exp_buckets",
           "linear_buckets"]
