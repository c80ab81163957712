"""Elastic re-meshing: shrink the data axis when hosts fail, reshard
from checkpoint, continue (port of ``repro/runtime/elastic.py``).

Policy: the ``model`` (TP/EP) axis is sacred — losing a rank there
breaks weight shards, so evictions remove whole data-parallel rows.
``plan_remesh`` computes the largest viable data extent given survivors;
``build_mesh`` gives the new mesh's shape and axes, for a fresh
``launch.mesh.run_ranks`` (the port runs one process per rank, so a new
mesh is a new set of ranks); ``reshard`` cuts a full-array tree (the
checkpoint is mesh-agnostic since it stores full arrays) into this
rank's shard of the new mesh.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Sequence, Tuple

from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.tp import block_of
from repro_torch.models.param import is_spec


@dataclass(frozen=True)
class RemeshPlan:
    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    dropped_hosts: Tuple[int, ...]
    global_batch_scale: float  # keep per-replica batch fixed; scale global


def plan_remesh(mesh_shape: Sequence[int], axes: Sequence[str],
                failed_data_rows: Sequence[int]) -> RemeshPlan:
    """Drop failed rows from the ``data`` axis; keep ``model`` intact."""
    shape = tuple(mesh_shape)
    axes = tuple(axes)
    di = axes.index("data")
    new_data = shape[di] - len(set(failed_data_rows))
    if new_data < 1:
        raise RuntimeError("no healthy data-parallel rows remain")
    new_shape = shape[:di] + (new_data,) + shape[di + 1:]
    return RemeshPlan(
        old_shape=shape,
        new_shape=new_shape,
        axes=axes,
        dropped_hosts=tuple(sorted(set(failed_data_rows))),
        global_batch_scale=new_data / shape[di],
    )


def build_mesh(plan: RemeshPlan) -> Tuple[int, Tuple[int, ...], Tuple[str, ...]]:
    """``(n ranks, shape, axes)`` of the new mesh: the arguments of
    ``run_ranks(fn, n, shape=shape, axes=axes, ...)``."""
    return math.prod(plan.new_shape), plan.new_shape, plan.axes


def reshard(tree: Any, spec_tree: Any, mesh, rules) -> Any:
    """This rank's blocks of a full-array tree on ``mesh`` under the same
    rules.  ``spec_tree`` holds ``ParamSpec`` leaves (resolved here) or
    resolved specs (``decoder.train_specs``)."""
    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, s[i]) for i, v in enumerate(t)]
        spec = shlib.spec_for(s.axes, rules, mesh, s.shape) if is_spec(s) else s
        return block_of(t, spec, mesh)

    return walk(tree, spec_tree)
