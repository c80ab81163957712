"""Collective-byte and op accounting for the roofline: the counterpart
of ``repro/analysis/hlo.py``.

The reference parses the compiled, SPMD-partitioned HLO module.  The
port has no HLO: each rank runs its own program, so it counts the
collectives a step actually issues.  Every collective entry point of
the port (``distributed.sharding.all_reduce_``, ``psum_if_tp``,
``distributed.tp.gather_stats``) appends a record to
``sharding.RECORDS``: the **logical** kind (gloo runs a gather as an
all-reduce into zeros, NCCL on a production mesh would run an
all-gather), the operand bytes as the HLO shapes it, the bytes issued,
and the group's members.  ``collective_bytes`` applies hlo.py's ring
formulas to them:

    all-gather:          out_bytes * (n-1)/n
    reduce-scatter:      out_bytes * (n-1)     (out is this rank's block)
    all-reduce:          2 * bytes * (n-1)/n   (RS + AG)
    all-to-all:          bytes * (n-1)/n
    collective-permute:  bytes

The sums are this rank's wire bytes.  A group whose members lie in
more than one node (``node_size`` ranks, row-major) goes over the
network, the rest over NVLink: the production mesh lays out ``model``
minor, so each 16-rank ``model`` group spans two nodes of 8.

``count_ops`` is the counterpart of ``hlo.count_ops``: the aten ops one
step dispatches (``TorchDispatchMode``), the matmul family (the
reference's ``dot``), the port's CUDA kernel launches (its
``custom-call``) and the total, which on the card is the step's launch
count.
"""
from __future__ import annotations

import functools
from collections import defaultdict
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

#: aten ops counted as ``dot``
DOT_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm", "addbmm", "matmul",
                     "dot", "mv", "addmv", "linear", "_scaled_mm"})


def wire_bytes(kind: str, nbytes: float, n: int) -> float:
    """Wire bytes of one collective of ``kind`` over ``n`` ranks whose
    operand is ``nbytes`` (hlo.py's ring formulas)."""
    if kind == "all-gather":
        return nbytes * (n - 1) / max(n, 1)
    if kind == "reduce-scatter":
        return nbytes * (n - 1)
    if kind == "all-reduce":
        return 2 * nbytes * (n - 1) / max(n, 1)
    if kind == "all-to-all":
        return nbytes * (n - 1) / max(n, 1)
    if kind == "collective-permute":
        return nbytes
    raise ValueError(f"unknown collective kind {kind!r}")


def crosses_node(ranks: Sequence[int], node_size: int) -> bool:
    """Whether a group's members lie in more than one node."""
    return node_size > 0 and len({int(r) // node_size for r in ranks}) > 1


def collective_bytes(records: Iterable[Dict], node_size: int = 8
                     ) -> Dict[str, float]:
    """Per-rank wire bytes per collective kind and in total
    (``bytes_<kind>``, ``count_<kind>``, ``bytes_total``), split into
    ``bytes_nvlink`` (groups inside a node) and ``bytes_network``
    (groups that cross one) in place of hlo.py's ICI / DCN."""
    out: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    network = 0.0
    for rec in records:
        kind = rec["kind"]
        wire = wire_bytes(kind, rec["bytes"], len(rec["ranks"]))
        out[kind] += wire
        counts[kind] += 1
        if crosses_node(rec["ranks"], node_size):
            network += wire
    total = sum(out.values())
    result = {f"bytes_{k}": v for k, v in out.items()}
    result.update({f"count_{k}": float(v) for k, v in counts.items()})
    result["bytes_total"] = total
    result["bytes_network"] = network
    result["bytes_nvlink"] = total - network
    return dict(result)


def summary(records: Iterable[Dict]) -> Dict[str, Dict[str, int]]:
    """``{kind: {"count", "bytes", "issued_bytes"}}`` of a record list:
    what two runs of one step must agree on."""
    out: Dict[str, Dict[str, int]] = {}
    for rec in records:
        d = out.setdefault(rec["kind"], {"count": 0, "bytes": 0,
                                         "issued_bytes": 0})
        d["count"] += 1
        d["bytes"] += int(rec["bytes"])
        d["issued_bytes"] += int(rec["issued_bytes"])
    return out


#: elementwise aten ops whose ``meta`` result ``count_ops`` builds itself
#: (shape by broadcasting, dtype by promotion): PyTorch's own meta
#: versions of these run as Python decompositions, ~0.3 ms a call, the
#: bulk of a dry-run step
_PROMOTE = frozenset({"add", "sub", "mul", "div", "where", "pow", "maximum",
                      "minimum", "floor_divide", "remainder"})
_COMPARE = frozenset({"lt", "le", "gt", "ge", "eq", "ne", "logical_and",
                      "logical_or", "bitwise_and", "bitwise_or"})
_UNARY = frozenset({"exp", "neg", "rsqrt", "sqrt", "log", "abs", "tanh",
                    "sigmoid", "silu", "relu", "reciprocal", "logical_not",
                    "clamp", "clamp_min", "clamp_max"})


@functools.lru_cache(maxsize=4096)
def _broadcast(shapes: Tuple[Tuple[int, ...], ...]) -> Optional[Tuple[int, ...]]:
    """The broadcast of ``shapes`` (``torch.broadcast_shapes``, which is
    slow on every call), or None where they do not broadcast."""
    n = max(len(sh) for sh in shapes)
    out = []
    for i in range(n):
        dims = {sh[len(sh) - n + i] for sh in shapes if len(sh) - n + i >= 0} - {1}
        if len(dims) > 1:
            return None
        out.append(dims.pop() if dims else 1)
    return tuple(out)


def _fast_meta(func, args, kwargs):
    """The ``meta`` result of an out-of-place elementwise op (contiguous),
    or None to run the op itself."""
    import torch

    name = func.overloadpacket.__name__
    if name not in _PROMOTE and name not in _COMPARE and name not in _UNARY:
        return None
    if func._schema.name.endswith("_") or kwargs.get("out") is not None:
        return None
    if any(isinstance(a, torch.Tensor) and a.device.type != "meta"
           for a in args):
        return None
    ts = [a for a in args if isinstance(a, torch.Tensor)]
    if not ts:
        return None
    if name in _COMPARE or name == "logical_not":
        dtype = torch.bool
    elif name == "where":
        dtype = torch.result_type(args[1], args[2])
    elif name in _UNARY and name not in ("clamp", "clamp_min", "clamp_max"):
        dtype = ts[0].dtype
        if not dtype.is_floating_point and name not in ("neg", "abs", "relu",
                                                        "logical_not"):
            dtype = torch.get_default_dtype()
    else:
        vals = [a for a in args if isinstance(a, (torch.Tensor, int, float, bool))]
        dtype = torch.result_type(*vals[:2]) if len(vals) > 1 else ts[0].dtype
        if name == "div" and not dtype.is_floating_point and \
                kwargs.get("rounding_mode") is None:
            dtype = torch.get_default_dtype()
    shape = _broadcast(tuple(tuple(t.shape) for t in ts))
    if shape is None:
        return None
    return torch.empty(shape, dtype=dtype, device="meta")


def count_ops(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """Run ``fn(*args, **kwargs)`` once and count what it dispatches:
    ``dot`` (the matmul family), ``custom-call`` (the port's CUDA kernel
    launches, from the kernel wrappers' counters: none on the CPU or
    ``meta``) and ``total`` (every aten op plus the kernel launches).
    On ``meta`` tensors the common elementwise ops take a fast path to
    their result's shape and dtype (``_fast_meta``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch.mesh import launch_counts

    counts = {"dot": 0, "custom-call": 0, "total": 0}

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts["total"] += 1
            kwargs = kwargs or {}
            if func.overloadpacket.__name__ in DOT_OPS:
                counts["dot"] += 1
            out = _fast_meta(func, args, kwargs)
            return func(*args, **kwargs) if out is None else out

    before = launch_counts()
    with _Count():
        fn(*args, **kwargs)
    after = launch_counts()
    # prefill_* / verify_* are subsets of the attention kernel's counts
    counts["custom-call"] = sum(
        v - before.get(k, 0) for k, v in after.items()
        if not k.split(".")[-1].startswith(("prefill_", "verify_")))
    counts["total"] += counts["custom-call"]
    return counts
