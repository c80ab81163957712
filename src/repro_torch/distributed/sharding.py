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
identity, so the single-device path is untouched.  Each rank runs its
own shard's program (the reference's shard_map form).  Only the paged
serving rules are ported; the training-mesh rule table comes with the
training mesh.
"""
from __future__ import annotations

import contextlib
import threading
import warnings
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.models.param import tree_map_specs

MeshAxes = Union[None, str, Tuple[str, ...]]
Rules = Dict[str, MeshAxes]
#: a resolved spec: per dimension the mesh axis (or axes) or None
Spec = Tuple[MeshAxes, ...]

_state = threading.local()


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

