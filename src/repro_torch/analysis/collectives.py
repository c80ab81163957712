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

``count_ops`` is the counterpart of ``hlo.count_ops`` and of the
reference dry-run's ``compiled.cost_analysis()`` and
``compiled.memory_analysis()``: one pass of a ``TorchDispatchMode`` over
the step counts the aten ops it dispatches (the matmul family is the
reference's ``dot``, the port's CUDA kernel launches its
``custom-call``), their FLOPs and bytes, and the storages they create
(``Count``).
"""
from __future__ import annotations

import functools
import weakref
from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

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
#: ops whose ``meta`` result ``count_ops`` also builds, each by its own
#: rule (``_fast_shape``): their meta versions take 0.05-0.4 ms a call,
#: half of a routed-MoE cell's step; without this path the one-pod
#: dry-runs (``launch.dryrun --all --pods 1``) take ~23% longer
_SHAPED = frozenset({"index", "arange", "cat", "new_zeros", "new_empty",
                     "new_ones", "full_like", "empty_like", "zeros_like",
                     "ones_like"})


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


def _fast_shape(name: str, args, kwargs):
    """``(shape, dtype)`` of a ``_SHAPED`` op's contiguous ``meta`` result,
    or None to run the op itself: ``x[i]`` with one integer index tensor,
    ``arange`` over ints, ``cat`` of contiguous tensors of one dtype,
    ``new_*`` and ``*_like`` of a contiguous tensor."""
    import torch

    meta = torch.device("meta")
    if kwargs.get("device", meta) != meta:
        return None
    if name == "arange":
        if not all(type(a) is int for a in args):
            return None
        start, end, step = (0, args[0], 1) if len(args) == 1 else (*args, 1)[:3]
        return (max(0, -((start - end) // step)),), kwargs.get("dtype") or torch.int64
    if name == "index":
        x, idx = args
        i = idx[0] if len(idx) == 1 else None
        if i is None or i.dtype not in (torch.int64, torch.int32) or \
                i.device != meta:
            return None
        return tuple(i.shape) + tuple(x.shape[1:]), x.dtype
    if name == "cat":
        ts, dim = args[0], (args[1] if len(args) > 1 else kwargs.get("dim", 0))
        if not ts:
            return None
        t0 = ts[0]
        dim %= max(t0.dim(), 1)
        if any(t.dtype != t0.dtype or t.dim() != t0.dim() or t.device != meta
               or not t.is_contiguous() or t.shape[:dim] != t0.shape[:dim]
               or t.shape[dim + 1:] != t0.shape[dim + 1:] for t in ts):
            return None
        shape = list(t0.shape)
        shape[dim] = sum(t.shape[dim] for t in ts)
        return tuple(shape), t0.dtype
    x = args[0]
    dtype = kwargs.get("dtype") or x.dtype
    if name.startswith("new_"):
        return tuple(args[1]), dtype
    if not x.is_contiguous() or kwargs.get("memory_format") not in (
            None, torch.preserve_format, torch.contiguous_format):
        return None
    return tuple(x.shape), dtype


def _fast_meta(func, args, kwargs):
    """The ``meta`` result of an out-of-place elementwise op or of a
    ``_SHAPED`` op (contiguous), or None to run the op itself."""
    import torch

    name = func.overloadpacket.__name__
    shaped = name in _SHAPED
    if not shaped and name not in _PROMOTE and name not in _COMPARE and \
            name not in _UNARY:
        return None
    if func._schema.name.endswith("_") or kwargs.get("out") is not None:
        return None
    if any(isinstance(a, torch.Tensor) and a.device.type != "meta"
           for a in args):
        return None
    if shaped:
        res = _fast_shape(name, args, kwargs)
        return None if res is None else torch.empty(res[0], dtype=res[1],
                                                      device="meta")
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


#: ops of ``Count.cost["by_op"]``: the largest by FLOPs, then by bytes
BY_OP = 10
#: ops whose result aliases an operand though their schema says no view
ALIAS_OPS = frozenset({"_unsafe_view"})


@dataclass
class Count:
    """What one step dispatched (``count_ops``).

    ``ops``: ``dot`` (the matmul family), ``custom-call`` (the port's
    CUDA kernel launches, from the kernel wrappers' counters: none on the
    CPU or ``meta``) and ``total`` (every aten op plus the launches).

    ``cost`` (``cost_analysis()``'s counterpart):

    * ``flops``: the ops of ``torch.utils.flop_counter``'s registry (the
      matmul family, convolutions, attention), 2 per multiply-add: what
      ``analysis.analytic.cell_cost`` counts;
    * ``elementwise_flops``: one per floating-point result element of
      every other op that is not a view (copies and fills included);
      with ``flops``, XLA's convention, kept apart;
    * ``bytes_accessed``: operand plus result bytes of every op that is
      not a view (``func.is_view``: a view moves nothing), each op on its
      own, as an eager step runs them (no fusion): traffic, not a bound;
    * ``by_op``: the ``BY_OP`` largest ops by FLOPs, then by bytes
      (``{op: {count, flops, elementwise_flops, bytes}}``);
    * ``plain_versions``: the kernel wrappers that ran their plain
      version (a CPU or ``meta`` tensor, ``kernels.backend.plain``), with
      the ops counted inside them.  On the card the kernel runs instead,
      and its work is not dispatched.

    ``memory`` (``memory_analysis()``'s counterpart, by storage: views
    share one):

    * ``argument_size_in_bytes``: the storages of the arguments;
    * ``output_size_in_bytes``: storages of the result the step created;
    * ``alias_size_in_bytes``: storages of the result that are an
      argument's (a cache written in place and returned);
    * ``temp_size_in_bytes``: the peak, during the step, of the live
      storages the step created (outputs included while they live; a
      storage kept by a reference cycle lives until Python's cyclic
      collector runs, here as on the card);
    * ``peak_bytes``: arguments plus temp, what the step needs.

    XLA's ``generated_code_size_in_bytes`` has no counterpart.  What is
    allocated outside the dispatcher (a library's workspace, a kernel
    launched through ``ctypes``) is not seen."""
    ops: Dict[str, int]
    cost: Dict[str, Any]
    memory: Dict[str, int]


def _tree_tensors(tree, out: List) -> List:
    """The tensors of a tree of dicts, lists and tuples, appended to ``out``."""
    import torch

    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tree_tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tree_tensors(v, out)
    return out


class _Tally:
    """The cost and the live storages of one step."""

    def __init__(self, args) -> None:
        import torch
        from torch.utils.flop_counter import flop_registry

        from repro_torch.kernels.backend import PLAIN

        self.tensor, self.registry, self.running = torch.Tensor, flop_registry, PLAIN
        self.args = {}  # storage key -> bytes of the arguments' storages
        for t in _tree_tensors(args, []):
            s = t.untyped_storage()
            self.args[s._cdata] = s.nbytes()
        self.new: Dict[int, int] = {}  # storage key -> bytes, while it lives
        self.refs: Dict[Any, int] = {}  # weak reference -> storage key
        self.live = self.peak = 0
        # op -> (its results' storages may be new?, it moves bytes?, its
        # row of by_op, its FLOP formula or None)
        self.kinds: Dict[Any, Tuple[bool, bool, List[int], Optional[Callable]]] = {}
        self.by_op: Dict[str, List[int]] = {}  # name -> [count, flops, ew, bytes]
        self.plain: Dict[str, List[int]] = defaultdict(lambda: [0, 0, 0])

    def _kind(self, func):
        """A view (``func.is_view``) creates no storage and moves nothing;
        ``lift_fresh`` hands the step a constant it built (a new storage)
        and moves nothing; an in-place op writes an operand's storage (no
        op of the port's steps resizes one)."""
        packet = func.overloadpacket
        name = packet.__name__
        row = self.by_op.setdefault(name, [0, 0, 0, 0])
        if name == "lift_fresh":
            return True, False, row, None
        if func.is_view or name in ALIAS_OPS:
            return False, False, row, None
        in_place = func._schema.name.endswith("_")
        return not in_place, True, row, self.registry.get(packet)

    def _free(self, ref) -> None:
        self.live -= self.new.pop(self.refs.pop(ref))

    def op(self, func, args, kwargs, out) -> None:
        kind = self.kinds.get(func)
        if kind is None:
            kind = self.kinds[func] = self._kind(func)
        track, moves, row, flop = kind
        if not (track or moves):
            return
        tensor = self.tensor
        outs = (out,) if isinstance(out, tensor) else _tree_tensors(out, [])
        if track:  # the storages the op created
            for t in outs:
                st = t.untyped_storage()
                key = st._cdata
                if key in self.args or key in self.new:
                    continue
                self.new[key] = n = st.nbytes()
                self.refs[weakref.ref(st, self._free)] = key
                self.live += n
                if self.live > self.peak:
                    self.peak = self.live
        if not moves:
            return
        nbytes = flops = ew = 0
        for a in args:
            if isinstance(a, tensor):
                nbytes += a.nbytes
            elif isinstance(a, (list, tuple)):
                for v in a:
                    if isinstance(v, tensor):
                        nbytes += v.nbytes
        if kwargs:
            for v in kwargs.values():
                if isinstance(v, tensor):
                    nbytes += v.nbytes
        for t in outs:
            nbytes += t.nbytes
            if flop is None and t.is_floating_point():
                ew += t.numel()
        if flop is not None:
            flops = int(flop(*args, **kwargs, out_val=out))
        row[0] += 1
        row[1] += flops
        row[2] += ew
        row[3] += nbytes
        if self.running:
            p = self.plain[self.running[-1]]
            p[0] += flops
            p[1] += ew
            p[2] += nbytes

    def result(self, res) -> Tuple[Dict, Dict]:
        out = alias = 0
        seen = set()
        for t in _tree_tensors(res, []):
            s = t.untyped_storage()
            if s._cdata in seen:
                continue
            seen.add(s._cdata)
            if s._cdata in self.args:
                alias += s.nbytes()
            else:
                out += s.nbytes()
        rows = sorted(self.by_op.items(), key=lambda kv: (-kv[1][1], -kv[1][3]))
        cost = {
            "flops": sum(r[1] for r in self.by_op.values()),
            "elementwise_flops": sum(r[2] for r in self.by_op.values()),
            "bytes_accessed": sum(r[3] for r in self.by_op.values()),
            "by_op": {k: dict(count=r[0], flops=r[1], elementwise_flops=r[2],
                              bytes=r[3]) for k, r in rows[:BY_OP]},
            "plain_versions": {k: dict(flops=p[0], elementwise_flops=p[1],
                                       bytes=p[2])
                               for k, p in sorted(self.plain.items())},
        }
        self.refs.clear()  # no frees are counted after the step
        args = sum(self.args.values())
        memory = {"argument_size_in_bytes": args, "output_size_in_bytes": out,
                  "alias_size_in_bytes": alias,
                  "temp_size_in_bytes": self.peak,
                  "peak_bytes": args + self.peak}
        return cost, memory


def count_ops(fn: Callable, *args, **kwargs) -> Count:
    """Run ``fn(*args, **kwargs)`` once and count what it dispatches
    (``Count``).  On ``meta`` tensors the common elementwise ops and a few
    others take a fast path to their result's shape and dtype
    (``_fast_meta``).

    The mode is thread-local: where autograd runs a backward on another
    thread (CUDA), that backward is not counted, so count a train step on
    ``meta`` or the CPU."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch.mesh import launch_counts

    counts = {"dot": 0, "custom-call": 0, "total": 0}
    tally = _Tally((args, kwargs))

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts["total"] += 1
            kwargs = kwargs or {}
            if func.overloadpacket.__name__ in DOT_OPS:
                counts["dot"] += 1
            out = _fast_meta(func, args, kwargs)
            if out is None:
                out = func(*args, **kwargs)
            tally.op(func, args, kwargs, out)
            return out

    before = launch_counts()
    with _Count():
        res = fn(*args, **kwargs)
    after = launch_counts()
    # prefill_* / verify_* are subsets of the attention kernel's counts
    counts["custom-call"] = sum(
        v - before.get(k, 0) for k, v in after.items()
        if not k.split(".")[-1].startswith(("prefill_", "verify_")))
    counts["total"] += counts["custom-call"]
    cost, memory = tally.result(res)
    return Count(counts, cost, memory)
