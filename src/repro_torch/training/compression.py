"""int8 error-feedback gradient all-reduce (port of
``repro/training/compression.py``).

Cross-pod gradient sync rides the slow links; quantizing to int8 with
**error feedback** (the residual is carried to the next step) is meant
to cut that traffic 4x with negligible convergence impact.  As in the
reference, op for op, each rank quantizes its (gradient + residual),
keeps the quantization error as its next residual, and the ranks sum
the *dequantized* fp32 values: the wire carries fp32, so neither package
cuts wire bytes yet.  The port runs one process per rank, and the sum is
one ``all_reduce`` over the mesh's ``data`` group per leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch.distributed.sharding import all_reduce_


def _quantize_leaf(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.amax(torch.abs(x)) / 127.0
    q = torch.round(x / torch.clamp_min(scale, 1e-12)).to(torch.int8)
    return q, scale


def _dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def compressed_psum(grads: Any, residual: Any, group) -> Tuple[Any, Any]:
    """Quantize (grad + residual) -> int8, sum the dequantized values over
    ``group``; the residual carries this rank's quantization error.
    Returns (summed grads, new residual)."""
    summed, new_res = [], []

    def one(g, r):
        g = g.to(torch.float32) + r
        q, scale = _quantize_leaf(g)
        deq_local = _dequantize_leaf(q, scale)
        new_res.append(g - deq_local)  # local quantization error -> next step
        # scales vary per peer, so the scale-weighted values are summed
        summed.append(all_reduce_(deq_local.clone(), group))

    _tree_map(one, grads, residual)
    s_it, r_it = iter(summed), iter(new_res)
    return (_tree_map(lambda _: next(s_it), grads),
            _tree_map(lambda _: next(r_it), grads))


def make_compressed_allreduce(mesh, axis_name: str = "data"):
    """Returns allreduce(grads, residual) -> (mean_grads, residual) that
    int8-compresses each rank's contribution over ``axis_name`` of
    ``mesh`` (a ``launch.mesh.TrainMesh``), error feedback carried."""
    n = mesh.shape[axis_name]
    group = mesh.group(axis_name)

    def fn(grads, residual):
        s, nr = compressed_psum(grads, residual, group)
        return _tree_map(lambda x: x / n, s), nr

    return fn


def init_residual(grads_like: Any) -> Any:
    return _tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                           device=g.device), grads_like)
