"""Logical-axis sharding rules and the tensor-parallel hooks (port of
``repro/distributed/sharding.py``).

A *rule set* maps logical axis names (see ``repro_torch.models.param``)
to mesh axis names (or tuples of them, or None).  ``spec_for`` resolves a
leaf's logical axes to a *spec*: a tuple with, per dimension, the mesh
axis (or tuple of axes) it is split over, or None, trailing Nones
dropped — the reference's ``PartitionSpec`` as plain data.

Resolution is **divisibility-aware**: a mesh axis that does not evenly
divide the corresponding dimension is dropped (replicated) rather than
erroring.  Each distinct drop emits a one-time warning: a silently
replicated weight is an N-fold memory regression (the GRIFFIN-compacted
FF width is the canonical trap; ``GriffinConfig(tp_shards=N)`` rounds
``k`` up to a divisible width).

The tensor-parallel hooks of the paged serving path: inside
``with tp_axis(mesh)`` (entered by the per-rank step wrappers of
``repro_torch.distributed.tp``), ``psum_if_tp`` all-reduces its argument
over the mesh's process group, in place.  The layers call it after every
contraction over a sharded axis (attention out-projection, FF
down-projection, GRIFFIN row norms).  Outside the scope it is the
identity, so the single-device path is untouched.  It has no backward and
serves only the serving path, which builds no autograd graph.

The training mesh (``launch.mesh.TrainMesh``, rules from ``make_rules``):
inside ``with axis_rules(mesh, rules)`` each rank runs its own shard's
program (the reference's ``shard_map`` form, where the reference itself
leaves the collectives to GSPMD), and the layers meet the other ranks
through the differentiable collectives below, each a conjugate pair
built on ``all_reduce`` alone (gloo reduces CUDA tensors with
``all_reduce`` and ``broadcast`` only):

* ``enter(x, axis)``: identity forward, all-reduce backward — where a
  replicated activation enters a computation split over ``axis``
  (before a column-split projection);
* ``reduce(x, axis)``: all-reduce forward, identity backward — the
  partial sums after a row-split projection;
* ``gather(xs, dims, axis)``: all-gather forward, reduce-scatter backward
  (FSDP's per-layer weight gather): each rank writes its block into a
  zeroed buffer of the full size and the buffer is all-reduced, which is
  exact; the backward all-reduces the full gradient and keeps the block;
* ``block_in`` / ``block_out``: ``enter`` / ``reduce`` over ``model``,
  or under sequence parallelism the identity and a reduce-scatter along
  the sequence (``seq_gather`` reads the whole sequence before a block);
* ``exchange_in`` / ``exchange_out``: rows of a token chunk gathered
  from their owners, partial outputs summed and cut back to them (the
  experts over ``(data, model)`` without a group limit).
"""
from __future__ import annotations

import contextlib
import threading
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.models.param import tree_map_specs

MeshAxes = Union[None, str, Tuple[str, ...]]
Rules = Dict[str, MeshAxes]
#: a resolved spec: per dimension the mesh axis (or axes) or None
Spec = Tuple[MeshAxes, ...]

_state = threading.local()


def _current() -> Tuple[Any, Optional[Rules]]:
    return getattr(_state, "mesh", None), getattr(_state, "rules", None)


@contextlib.contextmanager
def axis_rules(mesh, rules: Rules):
    """Run the enclosed layers as one rank's shard of the training mesh
    ``mesh`` (a ``launch.mesh.TrainMesh``) under ``rules``."""
    prev = _current()
    _state.mesh, _state.rules = mesh, rules
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def active_rules() -> Tuple[Any, Optional[Rules]]:
    """``(mesh, rules)`` of the active ``axis_rules`` scope, or Nones."""
    return _current()


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """The reference's activation-sharding hint, as the identity.

    The reference hands GSPMD a layout for ``x`` and lets it place the
    collectives; here each rank runs its own shard's program, so an
    activation already has the layout its producer gave it and the
    layers place their collectives themselves.  Kept so layer code reads
    as the reference's; it checks the rank of ``axes`` as the reference
    does."""
    mesh, rules = _current()
    if mesh is not None and rules is not None and len(axes) != x.dim():
        raise ValueError(f"axes {axes} rank != array rank {x.dim()} "
                         f"({tuple(x.shape)})")
    return x


# ---------------------------------------------------------------------------
# differentiable collectives of the training mesh
# ---------------------------------------------------------------------------

def _axes(axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _group(axis):
    """The active mesh and its group over ``axis``; None for a group of
    one rank, whose collectives are the identity."""
    mesh, _ = _current()
    if mesh is None:
        raise RuntimeError("a training collective outside axis_rules")
    axes = _axes(axis)
    return mesh, mesh.group(axes) if mesh.extent(axes) > 1 else None


#: the training mesh's all-reduces in this process (calls, bytes sent
#: into them), for the per-step counts; ``reset_traffic`` zeroes them
TRAFFIC = {"calls": 0, "bytes": 0}

#: every collective this process issued, in order: ``{"kind"`` (the
#: logical kind: ``all-reduce``, ``all-gather`` or ``reduce-scatter``),
#: ``"bytes"`` (the operand as XLA's HLO shapes it: the gathered result
#: of an all-gather, this rank's block of a reduce-scatter's result, the
#: operand of an all-reduce), ``"issued_bytes"`` (what went into the
#: backend's call: gloo and the dry group run every kind as an
#: all-reduce of the full buffer), ``"ranks"`` (the group's members)``}``.
#: ``analysis.collectives`` turns them into wire bytes;
#: ``reset_records`` empties the list.
RECORDS: List[Dict[str, Any]] = []


def reset_traffic() -> None:
    TRAFFIC.update(calls=0, bytes=0)


def reset_records() -> None:
    RECORDS.clear()


class DryGroup:
    """A stand-in for a process group of ``ranks`` (global rank ids): its
    collectives are recorded and leave their tensors as they are.  The
    dry-run steps one rank's program on ``meta`` tensors over such
    groups (``launch.mesh.dry_train_mesh``); it is never a real group."""

    def __init__(self, ranks: Sequence[int]):
        self.ranks = tuple(int(r) for r in ranks)

    def size(self) -> int:
        return len(self.ranks)

    def __repr__(self) -> str:
        return f"DryGroup({list(self.ranks)})"


def group_ranks(group) -> Tuple[int, ...]:
    """The global ranks of ``group`` (a ``DryGroup`` or a process group;
    None is the default group)."""
    if isinstance(group, DryGroup):
        return group.ranks
    if group is None:
        group = dist.group.WORLD
    return tuple(dist.get_process_group_ranks(group))


def record(kind: str, nbytes: int, group, issued: Optional[int] = None) -> None:
    """Append one collective to ``RECORDS``."""
    RECORDS.append({"kind": kind, "bytes": int(nbytes),
                    "issued_bytes": int(nbytes if issued is None else issued),
                    "ranks": list(group_ranks(group))})


def all_reduce_(t: torch.Tensor, group, op=None, *, kind: str = "all-reduce",
                nbytes: Optional[int] = None) -> torch.Tensor:
    """``dist.all_reduce`` in place, counted in ``TRAFFIC`` and recorded
    in ``RECORDS`` as the logical ``kind`` it carries out with the
    operand size ``nbytes`` (default: ``t``'s); over a ``DryGroup`` it
    only records."""
    size = t.numel() * t.element_size()
    TRAFFIC["calls"] += 1
    TRAFFIC["bytes"] += size
    record(kind, size if nbytes is None else nbytes, group, size)
    if isinstance(group, DryGroup):
        return t
    if op is None:
        dist.all_reduce(t, group=group)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group`` in ``x``'s dtype (a fresh tensor)."""
    return all_reduce_(x.contiguous().clone(), group)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter(x: torch.Tensor, axis="model") -> torch.Tensor:
    """Identity forward, all-reduce over ``axis`` backward: a replicated
    activation entering a computation split over ``axis``."""
    mesh, group = _group(axis)
    return x if group is None else _Enter.apply(x, group)


def reduce(x: torch.Tensor, axis="model") -> torch.Tensor:
    """All-reduce over ``axis`` forward (in ``x``'s dtype, as
    ``lax.psum``), identity backward: the partial sums of a row-split
    projection, replicated after the sum."""
    mesh, group = _group(axis)
    return x if group is None else _Reduce.apply(x, group)


def _blocks(mesh, axis, shapes, dims):
    n, r = mesh.extent(_axes(axis)), mesh.coord(_axes(axis))
    return n, r, [tuple(s[:d]) + (s[d] * n,) + tuple(s[d + 1:])
                  for s, d in zip(shapes, dims)]


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, dims, *xs):
        group = mesh.group(_axes(axis))
        n, r, full = _blocks(mesh, axis, [x.shape for x in xs], dims)
        ctx.group, ctx.dims, ctx.n, ctx.r = group, dims, n, r
        ctx.meta = [(x.dtype, x.shape) for x in xs]
        outs: List[Optional[torch.Tensor]] = [None] * len(xs)
        for dt in dict.fromkeys(x.dtype for x in xs):
            idx = [i for i, x in enumerate(xs) if x.dtype == dt]
            total = sum(torch.Size(full[i]).numel() for i in idx)
            buf = torch.zeros(total, dtype=dt, device=xs[idx[0]].device)
            off = 0
            for i in idx:
                view = buf[off: off + torch.Size(full[i]).numel()].view(full[i])
                w = xs[i].shape[dims[i]]
                view.narrow(dims[i], r * w, w).copy_(xs[i])
                outs[i] = view
                off += view.numel()
            all_reduce_(buf, group, kind="all-gather")
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        grads: List[Optional[torch.Tensor]] = [None] * len(gs)
        for dt in dict.fromkeys(m[0] for m in ctx.meta):
            idx = [i for i, m in enumerate(ctx.meta) if m[0] == dt]
            parts = []
            for i in idx:
                full = list(ctx.meta[i][1])
                full[ctx.dims[i]] *= ctx.n
                g = gs[i]
                parts.append(torch.zeros(full, dtype=dt,
                                         device=_device_of(gs)).reshape(-1)
                             if g is None else g.to(dt).reshape(-1))
            buf = torch.cat(parts)
            all_reduce_(buf, ctx.group, kind="reduce-scatter",
                        nbytes=buf.numel() * buf.element_size() // ctx.n)
            off = 0
            for i in idx:
                full = list(ctx.meta[i][1])
                full[ctx.dims[i]] *= ctx.n
                size = torch.Size(full).numel()
                view = buf[off: off + size].view(full)
                w = ctx.meta[i][1][ctx.dims[i]]
                grads[i] = view.narrow(ctx.dims[i], ctx.r * w, w).contiguous()
                off += size
        return (None, None, None) + tuple(grads)


def _device_of(ts) -> torch.device:
    return next(t.device for t in ts if t is not None)


def gather(xs: Sequence[torch.Tensor], dims: Sequence[int],
           axis="data") -> Tuple[torch.Tensor, ...]:
    """All-gather each of ``xs`` along its ``dims[i]`` over ``axis``
    forward (one all-reduce per dtype: this rank's blocks written into a
    zeroed buffer of the full sizes), reduce-scatter backward (the full
    gradients all-reduced, this rank's blocks kept).  FSDP's weight
    gather: the backward sums the data ranks' gradients."""
    mesh, _ = _group(axis)
    if not xs:
        return ()
    return _Gather.apply(mesh, axis, tuple(dims), *xs)


class _GatherKeep(torch.autograd.Function):
    """All-gather forward; backward this rank's block of the gradient,
    unsummed (every rank computed the same whole gradient)."""

    @staticmethod
    def forward(ctx, x, d, axis):
        mesh, _ = _group(axis)
        ctx.d, ctx.w = d, x.shape[d]
        ctx.r = mesh.coord(_axes(axis))
        return _Gather.apply(mesh, axis, (d,), x)[0]

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.d, ctx.r * ctx.w, ctx.w).contiguous(), None, None


def gather_leaf(t: torch.Tensor, d: int, axis="model") -> torch.Tensor:
    """A leaf's block gathered whole along ``d`` over ``axis`` for a
    computation every rank of ``axis`` runs whole (GSPMD's replicated
    compute of a split leaf).  Its gradient is this rank's block of the
    whole gradient: taken as it is where every rank computed it alike,
    summed over the ranks under ``seq_parallel`` (``gather``), where each
    computed the part of its own block of the sequence."""
    if sp_active():
        return gather([t], [d], axis)[0]
    mesh, group = _group(axis)
    return t if group is None else _GatherKeep.apply(t, d, axis)


def all_sum(x: torch.Tensor, axis) -> torch.Tensor:
    """Sum over ``axis`` of a tensor outside autograd (metrics, counts);
    the identity for no axes or one rank."""
    mesh, axes = _live(axis)
    if mesh is None:
        return x
    return _all_reduce(x.detach(), mesh.group(axes))


def all_max(x: torch.Tensor, axis) -> torch.Tensor:
    """Maximum over ``axis`` of a tensor outside autograd."""
    mesh, axes = _live(axis)
    out = x.detach().contiguous().clone()
    if mesh is not None:
        all_reduce_(out, mesh.group(axes), dist.ReduceOp.MAX)
    return out


def batch_axes(mesh, rules: Optional[Rules] = None) -> Tuple[str, ...]:
    """The mesh axes the batch is split over (``pod``, ``data``)."""
    rule = (rules or {}).get("batch", ("pod", "data"))
    return tuple(a for a in _axes(rule or ()) if a in mesh.axis_names)


def model_split(local: int, full: int) -> bool:
    """Whether a dimension of ``full`` that a layer holds ``local`` of is
    split over ``model`` on the active training mesh (its spec kept the
    axis; a dimension whose axis was dropped for divisibility is whole)."""
    mesh, _ = _current()
    return mesh is not None and local != full


# ---------------------------------------------------------------------------
# sequence parallelism (``make_rules(seq_parallel=True)``)
# ---------------------------------------------------------------------------
#
# Between layers the residual stream is this rank's block of the sequence
# over ``model``.  A mixer or FF block reads the whole sequence
# (``seq_gather``: all-gather forward, reduce-scatter backward), its
# layers take their input as it is (``block_in``: the gather's backward
# already sums the ranks' partial gradients) and hand back this rank's
# block of the output (``block_out``: a reduce-scatter of the partial
# sums in place of the all-reduce, or a cut of a whole output).  The
# decoder turns it on per forward (``seq_parallel``), where the rules put
# ``seq`` on ``model`` and the length divides (decode's one token does
# not: there the stream is replicated, as the reference's divisibility-
# aware resolution leaves it).

@contextlib.contextmanager
def seq_parallel(on: bool):
    """Run the enclosed layers with the residual stream split along the
    sequence over ``model`` (``on``) or not."""
    prev = getattr(_state, "sp", False)
    _state.sp = bool(on)
    try:
        yield
    finally:
        _state.sp = prev


def sp_active() -> bool:
    """Whether the layers run under ``seq_parallel``."""
    return getattr(_state, "sp", False)


def sp_wanted(length: int) -> bool:
    """Whether the active rules split a sequence of ``length`` over
    ``model``: ``seq`` holds ``model``, the axis has more than one rank
    and divides the length."""
    mesh, rules = _current()
    if mesh is None or not rules or "model" not in _axes(rules.get("seq") or ()):
        return False
    n = mesh.extent("model") if "model" in mesh.axis_names else 1
    return n > 1 and length % n == 0


def _gather_along(x: torch.Tensor, d: int, mesh, axes) -> torch.Tensor:
    n, r = mesh.extent(axes), mesh.coord(axes)
    w = x.shape[d]
    shape = list(x.shape)
    shape[d] = w * n
    buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
    buf.narrow(d, r * w, w).copy_(x)
    return all_reduce_(buf, mesh.group(axes), kind="all-gather")


def _scatter_along(y: torch.Tensor, d: int, mesh, axes) -> torch.Tensor:
    n, r = mesh.extent(axes), mesh.coord(axes)
    w = y.shape[d] // n
    buf = all_reduce_(y.contiguous().clone(), mesh.group(axes),
                      kind="reduce-scatter",
                      nbytes=y.numel() * y.element_size() // n)
    return buf.narrow(d, r * w, w).contiguous()


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, d, summed):
        mesh, _ = _current()
        ctx.mesh, ctx.d, ctx.summed = mesh, d, summed
        ctx.w = x.shape[d]
        return _gather_along(x, d, mesh, ("model",))

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            return _scatter_along(g, ctx.d, ctx.mesh, ("model",)), None, None
        r = ctx.mesh.coord("model")
        return g.narrow(ctx.d, r * ctx.w, ctx.w).contiguous(), None, None


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, d):
        mesh, _ = _current()
        ctx.mesh, ctx.d = mesh, d
        return _scatter_along(y, d, mesh, ("model",))

    @staticmethod
    def backward(ctx, g):
        return _gather_along(g.contiguous(), ctx.d, ctx.mesh, ("model",)), None


def seq_gather(x: torch.Tensor, d: int = 1) -> torch.Tensor:
    """This rank's sequence block -> the whole sequence (all-gather over
    ``model``); the backward sums the ranks' partial gradients and keeps
    the block (a reduce-scatter): what a block split over ``model``
    reads."""
    return _SeqGather.apply(x, d, True)


def seq_replicate(x: torch.Tensor, d: int = 1) -> torch.Tensor:
    """The same gather for a computation every ``model`` rank runs whole
    (its gradient is the same on every rank): the backward keeps this
    rank's block of it."""
    return _SeqGather.apply(x, d, False)


def seq_cut(x: torch.Tensor, d: int = 1) -> torch.Tensor:
    """This rank's block of a whole sequence along ``d``."""
    mesh, _ = _current()
    w = x.shape[d] // mesh.extent("model")
    return x.narrow(d, mesh.coord("model") * w, w)


def block_in(x: torch.Tensor) -> torch.Tensor:
    """A replicated activation entering a computation split over
    ``model``: ``enter`` (its gradient summed over ``model``), or under
    ``seq_parallel`` the identity (the block's ``seq_gather`` sums it)."""
    return x if sp_active() else enter(x, "model")


def block_out(y: torch.Tensor, partial: bool = True, d: int = 1) -> torch.Tensor:
    """A block's output: partial sums of a row-split projection
    (``partial``) are reduced over ``model``, under ``seq_parallel``
    reduce-scattered along the sequence (dimension ``d``); a whole output
    passes, under ``seq_parallel`` cut to this rank's block."""
    if not sp_active():
        return reduce(y, "model") if partial else y
    return _SeqScatter.apply(y, d) if partial else seq_cut(y, d)


# ---------------------------------------------------------------------------
# token exchange of experts over (data, model) without a group limit
# ---------------------------------------------------------------------------

class _Exchange(torch.autograd.Function):
    """``out = psum_fwd(place(x))``: rows ``x`` written at ``pos`` of a
    zeroed ``[n, ...]`` buffer and all-reduced over ``fwd`` axes;
    backward: the gradient all-reduced over ``bwd`` axes, rows ``pos``
    kept.  With ``take`` the roles turn: forward all-reduce over ``fwd``
    then rows ``pos``; backward rows written at ``pos`` of zeros and
    all-reduced over ``bwd``."""

    @staticmethod
    def forward(ctx, x, pos, n, fwd, bwd, take):
        mesh, _ = _current()
        ctx.save_for_backward(pos)
        ctx.mesh, ctx.n, ctx.bwd, ctx.take = mesh, n, bwd, take
        ctx.rows = x.shape[0]
        if take:
            return _psum_rows(x, fwd, mesh, "reduce-scatter", pos.numel())[pos]
        return _place(x, pos, n, fwd, mesh)

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        g = g.contiguous()
        if ctx.take:
            out = _place(g, pos, ctx.n, ctx.bwd, ctx.mesh)
        else:
            out = _psum_rows(g, ctx.bwd, ctx.mesh, "reduce-scatter",
                             pos.numel())[pos]
        return out, None, None, None, None, None


def _place(x, pos, n, axes, mesh):
    buf = x.new_zeros((n,) + tuple(x.shape[1:]))
    buf[pos] = x
    if axes and mesh.extent(axes) > 1:
        all_reduce_(buf, mesh.group(axes), kind="all-gather")
    return buf


def _psum_rows(x, axes, mesh, kind, rows):
    if not axes or mesh.extent(axes) == 1:
        return x
    row = x[0].numel() * x.element_size()
    return all_reduce_(x.clone(), mesh.group(axes), kind=kind, nbytes=rows * row)


def exchange_in(x: torch.Tensor, pos: torch.Tensor, n: int, owners, summers):
    """Rows ``x`` of this rank, at positions ``pos`` of an ``n``-row
    chunk, gathered with the other ``owners`` ranks' rows (the chunk, on
    every rank); the backward sums the chunk's gradient over ``summers``
    (the ranks whose partial gradients add up) and keeps rows ``pos``."""
    return _Exchange.apply(x, pos, n, tuple(owners), tuple(summers), False)


def exchange_out(y: torch.Tensor, pos: torch.Tensor, summers, owners):
    """A chunk's partial outputs ``y`` summed over ``summers``, rows
    ``pos`` kept; the backward gathers the rows' gradients of the
    ``owners`` ranks into the chunk's."""
    return _Exchange.apply(y, pos, y.shape[0], tuple(summers), tuple(owners),
                           True)


# ---------------------------------------------------------------------------
# serving on the training mesh: plain collectives (no autograd), placed
# by resolved specs; an axis set of extent 1 is the identity
# ---------------------------------------------------------------------------

def dim_axes(spec, d: int) -> Tuple[str, ...]:
    """The mesh axes dimension ``d`` of a resolved ``spec`` is split over."""
    spec = tuple(spec)
    return _axes(spec[d]) if d < len(spec) and spec[d] is not None else ()


def _live(axes):
    mesh, _ = _current()
    axes = _axes(axes) if axes else ()
    if mesh is None or not axes or mesh.extent(axes) == 1:
        return None, ()
    return mesh, axes


def split_axes(spec, d: int) -> Tuple[str, ...]:
    """The axes that really split dimension ``d`` of a resolved ``spec``
    on the active mesh (extent above 1); () off a mesh or for no spec."""
    return () if spec is None else _live(dim_axes(spec, d))[1]


def gather_dim(t: torch.Tensor, d: int, axes) -> torch.Tensor:
    """All-gather ``t`` along ``d`` over ``axes`` (this rank's block written
    into zeros of the full size and summed: exact, and all gloo offers for
    CUDA tensors); recorded as the all-gather it is."""
    if not axes:  # the common case off a mesh, without a lookup
        return t
    mesh, axes = _live(axes)
    if mesh is None:
        return t
    n, r = mesh.extent(axes), mesh.coord(axes)
    w = t.shape[d]
    shape = list(t.shape)
    shape[d] = w * n
    buf = torch.zeros(shape, dtype=t.dtype, device=t.device)
    buf.narrow(d, r * w, w).copy_(t)
    return all_reduce_(buf, mesh.group(axes), kind="all-gather")


def slice_dim(t: torch.Tensor, d: int, axes) -> torch.Tensor:
    """This rank's block of ``t`` along ``d`` over ``axes``."""
    if not axes:
        return t
    mesh, axes = _live(axes)
    if mesh is None:
        return t
    n, r = mesh.extent(axes), mesh.coord(axes)
    w = t.shape[d] // n
    return t.narrow(d, r * w, w)


def relayout(t: torch.Tensor, moves: Dict[int, Tuple]) -> torch.Tensor:
    """``t`` with each dimension ``d`` of ``moves = {d: (have, want)}``,
    split over the axes ``have``, split over ``want`` instead: every
    changed dimension gathered first, then cut (a cut before another
    dimension's gather would mix the ranks' blocks)."""
    if not any(h or w for h, w in moves.values()):
        return t
    moves = {d: (tuple(h or ()), tuple(w or ())) for d, (h, w) in moves.items()}
    moves = {d: hw for d, hw in moves.items() if hw[0] != hw[1]}
    for d, (have, _) in moves.items():
        t = gather_dim(t, d, have)
    for d, (_, want) in moves.items():
        t = slice_dim(t, d, want)
    return t


def psum(t: torch.Tensor, axes) -> torch.Tensor:
    """Sum of ``t`` over ``axes`` in its dtype (a fresh tensor on a mesh)."""
    if not axes:
        return t
    mesh, axes = _live(axes)
    if mesh is None:
        return t
    return all_reduce_(t.contiguous().clone(), mesh.group(axes))


def pmax(t: torch.Tensor, axes) -> torch.Tensor:
    """Maximum of ``t`` over ``axes`` (a fresh tensor on a mesh)."""
    if not axes:
        return t
    mesh, axes = _live(axes)
    if mesh is None:
        return t
    return all_reduce_(t.contiguous().clone(), mesh.group(axes),
                       dist.ReduceOp.MAX)


# ---------------------------------------------------------------------------
# tensor-parallel hooks (paged serving; repro_torch.distributed.tp)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def tp_axis(mesh):
    """Run the enclosed layers as one rank's shard of ``mesh`` (a
    ``launch.mesh.ServingMesh``): ``psum_if_tp`` becomes an all-reduce
    over its process group."""
    prev = getattr(_state, "tp_mesh", None)
    _state.tp_mesh = mesh
    try:
        yield
    finally:
        _state.tp_mesh = prev


def tp_mesh():
    """The mesh of the active ``tp_axis`` scope, or None."""
    return getattr(_state, "tp_mesh", None)


def psum_if_tp(x: torch.Tensor) -> torch.Tensor:
    """Cross-rank sum under an active ``tp_axis``, else the identity.

    Sums ``x`` over the mesh's ranks **in place** and returns it.  The
    reduction runs in ``x``'s own dtype, as the reference's ``lax.psum``
    does, on both backends: bf16 partial sums of a bf16 model are added
    in bf16 (NCCL on the card; gloo, which stages CUDA tensors through
    host memory and adds them there), fp32 ones in fp32.  Every rank gets
    the same bits back, so the replicated residual stream, the logits
    and the greedy tokens stay identical across ranks.  At world size 1
    the collective still runs (it is the identity), so a one-rank mesh
    exercises the backend."""
    mesh = tp_mesh()
    if mesh is None:
        return x
    if not x.is_contiguous():
        raise ValueError("psum_if_tp: the partial sum must be contiguous")
    record("all-reduce", x.numel() * x.element_size(), mesh.group)
    dist.all_reduce(x, group=mesh.group)
    return x


def mesh_axis_size(mesh, name: str) -> int:
    """Size of one mesh axis."""
    return dict(mesh.shape)[name]


# Logical axes where a divisibility drop is routine and replication is
# the *intended* layout (transient activations, host-scheduler state):
# warning there would train operators to ignore the case the warning
# exists for, a persistent WEIGHT silently replicated N-fold.
_QUIET_DROP_AXES = frozenset(
    {"batch", "seq", "act_embed", "kv_seq", "window", "cap",
     "pages", "page", "layers"}
)

# one-time divisibility-drop warnings, keyed by (logical axis, mesh axis,
# residual dim, mesh size)
_div_warned: set = set()


def _warn_divisibility_drop(ax: Optional[str], mesh_name: str, dim: int,
                            rem: int, size: int) -> None:
    if ax in _QUIET_DROP_AXES:
        return
    key = (ax, mesh_name, rem, size)
    if key in _div_warned:
        return
    _div_warned.add(key)
    what = f"dimension {dim}" if rem == dim else \
        f"dimension {dim} (residual {rem} after earlier mesh axes)"
    msg = (
        f"sharding: dropping mesh axis {mesh_name!r} (size {size}) for "
        f"logical axis {ax!r}: {what} is not divisible — the tensor is "
        f"REPLICATED over {mesh_name!r} ({size}x the memory of the "
        f"sharded layout)."
    )
    if ax == "mlp":
        msg += (
            " For GRIFFIN-compacted FF weights, pad the selection to a "
            "divisible k_ff (GriffinConfig(tp_shards=N) rounds k up "
            "automatically)."
        )
    warnings.warn(msg, stacklevel=3)


def spec_for(
    axes: Sequence[Optional[str]],
    rules: Rules,
    mesh,
    dims: Optional[Sequence[int]] = None,
) -> Spec:
    """Resolve logical axes to a spec under ``rules``.

    * A mesh axis may appear only once in the spec; later conflicting
      occurrences are replicated.
    * If ``dims`` is given, mesh axes whose size does not divide the
      dimension are dropped, with a one-time warning per distinct
      (logical axis, mesh axis, dim, size).
    """
    used: set = set()
    out = []
    for i, ax in enumerate(axes):
        m = rules.get(ax) if ax is not None else None
        if m is None:
            out.append(None)
            continue
        names = (m,) if isinstance(m, str) else tuple(m)
        names = tuple(n for n in names if n not in used and n in mesh.axis_names)
        if dims is not None:
            kept = []
            rem = dims[i]
            for n in names:
                sz = mesh_axis_size(mesh, n)
                if rem % sz == 0:
                    kept.append(n)
                    rem //= sz
                else:
                    _warn_divisibility_drop(ax, n, dims[i], rem, sz)
            names = tuple(kept)
        if not names:
            out.append(None)
            continue
        used.update(names)
        out.append(names[0] if len(names) == 1 else names)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def tree_specs(spec_tree: Any, mesh, rules: Rules) -> Any:
    """Map a ParamSpec tree to a tree of resolved specs
    (divisibility-aware)."""
    return tree_map_specs(lambda s: spec_for(s.axes, rules, mesh, s.shape),
                          spec_tree)


# ---------------------------------------------------------------------------
# Rule policies
# ---------------------------------------------------------------------------

def make_rules(
    *,
    phase: str,  # "train" | "serve"
    fsdp: bool = False,
    seq_parallel: bool = False,
    expert_2d: bool = False,
    kv_seq_model: bool = False,
    head_dim_fallback: bool = False,
) -> Rules:
    """Build a logical->mesh rule set (the reference's table).

    fsdp:         shard the ``embed`` axis of weights over ``data``
                  (ZeRO-3-ish; weights gathered per layer).
    seq_parallel: shard boundary activations' ``seq`` over ``model``
                  (sequence parallelism: the decoder's residual stream
                  between blocks, ``seq_parallel`` above).
    expert_2d:    shard ``experts`` over (data, model)
                  (deepseek: 256 experts == 16x16 mesh exactly).
    kv_seq_model: additionally shard decode KV caches' sequence axis over
                  ``model`` — used when the arch's kv_heads cannot occupy
                  the model axis.
    """
    rules: Rules = {
        "batch": ("pod", "data"),
        "seq": ("model",) if seq_parallel else None,
        "act_embed": None,
        "embed": "data" if fsdp else None,
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        # decode-only TP fallback: when an arch's (kv-)head count can't
        # occupy the 16-way model axis, shard head_dim instead
        "head_dim": "model" if head_dim_fallback else None,
        "vocab": "model",
        "tok_vocab": None,  # untied embedding table rows: replicate
        "lora": None,
        "experts": ("data", "model") if expert_2d else "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "ssm_state": None,
        "lru": "model",
        "conv": None,
        "layers": None,
        # decode KV cache sequence axis: context parallelism over data
        # (and model, when kv-heads can't use it)
        "kv_seq": ("data", "model") if kv_seq_model else "data",
        "cap": None,
        "window": ("data", "model") if kv_seq_model else "data",
    }
    return rules


def make_paged_tp_rules(axis: str = "model") -> Rules:
    """Logical->mesh rules for tensor-parallel *paged serving*.

    Head-parallel attention + FF-hidden-parallel FFN on one mesh axis:
    ``heads``/``kv_heads`` shard the projections and the KV page pools,
    ``mlp`` shards the FF hidden axis (including the GRIFFIN-compacted
    per-slot expert weights, whose ``k_ff`` the selection pads to a
    multiple of the axis size).  Everything the host mutates or the
    ranks must agree on — block tables, positions, pages, the embed
    table and LM head — stays replicated, so logits come out replicated
    and the scheduler needs no device-aware logic.
    """
    return {
        "batch": None,
        "seq": None,
        "act_embed": None,
        "embed": None,
        "heads": axis,
        "kv_heads": axis,
        "head_dim": None,
        "mlp": axis,
        "vocab": None,
        "tok_vocab": None,
        "pages": None,
        "page": None,
        "layers": None,
    }


def describe(rules: Rules) -> str:
    return ", ".join(f"{k}->{v}" for k, v in rules.items() if v)
