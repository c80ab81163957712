"""Train-step builder: microbatch gradient accumulation + remat +
optimizer application (port of ``repro/training/train_step.py``).

A train state is a plain dict: ``params`` in the port's per-layer
layout, ``opt`` in the reference's scan-stacked layout (see
``optimizer.py``; the optimizer sees the parameters through
``bridge.ref_view``, which copies nothing) and ``step`` an int32 tensor.
``bridge.train_state_to_jax`` / ``train_state_from_jax`` carry it to and
from the reference's layout for checkpoints.  The step updates the
parameters and the optimizer state in place.

On a training mesh (``build_train_step(..., mesh=, rules=)``) every rank
holds its blocks of the train state (``distributed.tp.TrainTP``) and gets
the whole global batch: microbatch *m* is the reference's rows, of which
data rank *r* takes its slice.  The loss is the global ``nll / count``
(both summed over the batch axes before the division); after the
backward, each gradient is summed over the batch axes its leaf is not
split over, and each rank updates its own blocks.
"""
from __future__ import annotations

import functools
from contextlib import nullcontext
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import bridge
from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.tp import TrainTP
from repro_torch.models import decoder
from repro_torch.training.optimizer import Optimizer


def init_train_state(cfg, optimizer: Optimizer, seed: int = 0,
                     device=None) -> Dict:
    """Parameters drawn from ``seed`` on ``device`` (default: the card),
    the optimizer's initial state and step 0."""
    params = decoder.init_params(cfg, seed, device)
    dev = params["final_norm"]["scale"].device
    return {"params": params, "opt": optimizer.init(bridge.ref_view(params, cfg)),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def abstract_train_state(cfg, optimizer: Optimizer) -> Dict:
    """The train state as ``meta`` tensors (shapes and dtypes, no
    allocation)."""
    params = decoder.abstract_params(cfg)
    return {"params": params, "opt": optimizer.init(bridge.ref_view(params, cfg)),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def _walk(t: Any, leaves: List[torch.Tensor]) -> Any:
    """``t``'s skeleton: each tensor appended to ``leaves``, its index in
    its place."""
    if isinstance(t, dict):
        return {k: _walk(v, leaves) for k, v in t.items()}
    if isinstance(t, list):
        return [_walk(v, leaves) for v in t]
    leaves.append(t)
    return len(leaves) - 1


def _fill(skeleton: Any, vals: List[torch.Tensor]) -> Any:
    """The tree of ``skeleton`` with ``vals[i]`` in the place of index i."""
    if isinstance(skeleton, dict):
        return {k: _fill(v, vals) for k, v in skeleton.items()}
    if isinstance(skeleton, list):
        return [_fill(v, vals) for v in skeleton]
    return vals[skeleton]


def _flatten(tree: Any) -> Tuple[List[torch.Tensor], Callable]:
    """Tensors of a dict/list tree in order, and a function that builds
    the same tree from a list of new leaves.  The walks are module
    functions: a recursive closure is a reference cycle, which would hold
    the leaves (gradients too) until Python's cyclic collector ran."""
    leaves: List[torch.Tensor] = []
    return leaves, functools.partial(_fill, _walk(tree, leaves))


def value_and_grad(loss_fn: Callable, params: Dict, batch: Dict, cfg
                   ) -> Tuple[torch.Tensor, Dict, Dict]:
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch, cfg)``:
    ``grads`` mirrors ``params`` in their dtypes, with ``None`` for a
    leaf the loss does not read (``jax.grad`` gives zeros there)."""
    flat, rebuild = _flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss, metrics = loss_fn(rebuild(leaves), batch, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, rebuild(list(grads))


def _rows(mesh, rules, accum_steps: int, local: bool = False):
    """``slice_of(x, m)``: this data rank's rows of microbatch ``m`` (of
    the global batch, or with ``local`` of the rank's own rows)."""
    axes = shlib.batch_axes(mesh, rules) if mesh is not None and not local else ()
    n = mesh.extent(axes) if axes else 1
    r = mesh.coord(axes) if axes else 0

    def slice_of(x, m):
        B = x.shape[0]
        if B % (accum_steps * n):
            raise ValueError(f"batch of {B} rows does not split into "
                             f"{accum_steps} microbatches over {n} data ranks")
        mb = B // accum_steps
        w = mb // n
        return x[m * mb + r * w: m * mb + (r + 1) * w]

    return slice_of


def build_train_step(
    cfg,
    optimizer: Optimizer,
    accum_steps: int = 1,
    loss_fn: Optional[Callable] = None,
    mesh=None,
    rules=None,
    local_batch: bool = False,
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    ``batch`` holds tensors on the parameters' device.  ``accum_steps >
    1`` splits the batch into that many microbatches along its first
    axis and accumulates their gradients in fp32 (the activation-memory
    lever for the big configs); gradients and loss are then divided by
    ``accum_steps`` and the metrics are the loss alone.

    With ``mesh`` (a ``launch.mesh.TrainMesh``) and ``rules``, the step is
    this rank's share of the sharded step (module docstring): ``state``
    holds its blocks (``TrainTP(cfg, mesh, rules).init_train_state``, or
    ``bridge.train_state_from_jax(..., tp=)`` of a checkpoint), ``batch``
    the global rows (with ``local_batch``, this data rank's block of them,
    as a cell of ``launch.cells`` holds it; microbatch ``m`` is then the
    ``m``-th slice of that block).
    """
    loss_fn = loss_fn or decoder.loss_fn
    tp = TrainTP(cfg, mesh, rules) if mesh is not None else None
    shards = tp.leaf_shards() if tp is not None else None
    slice_of = _rows(mesh, rules, accum_steps, local_batch)

    def grads_of(params, mb):
        with shlib.axis_rules(mesh, rules) if tp is not None else nullcontext():
            loss, metrics, grads = value_and_grad(loss_fn, params, mb, cfg)
        flat, _ = _flatten(params)
        gflat, _ = _flatten(grads)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(flat, gflat)], loss, metrics

    def seq_parallel(mb) -> bool:
        """Whether the step split this microbatch's sequence over
        ``model`` (``decoder.loss_fn``)."""
        if tp is None:
            return False
        S = sum(mb[k].shape[1] for k in ("prefix_emb", "tokens") if k in mb)
        with shlib.axis_rules(mesh, rules):
            return shlib.sp_wanted(S)

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        flat, rebuild = _flatten(params)
        if accum_steps == 1:
            mb = {k: slice_of(v, 0) for k, v in batch.items()}
            g, loss, metrics = grads_of(params, mb)
        else:
            g = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in flat]
            loss = torch.zeros((), dtype=torch.float32, device=flat[0].device)
            for m in range(accum_steps):
                mb = {k: slice_of(v, m) for k, v in batch.items()}
                gm, lm, _ = grads_of(params, mb)
                g = [a + b.to(torch.float32) for a, b in zip(g, gm)]
                loss = loss + lm
            metrics = {}
        grads = rebuild(g)
        if tp is not None:
            grads = tp.sync_grads(grads, seq_parallel(mb))
        if accum_steps > 1:
            grads = rebuild([x / accum_steps for x in _flatten(grads)[0]])
            loss = loss / accum_steps
        _, new_opt = optimizer.update(bridge.ref_view(grads, cfg), state["opt"],
                                      bridge.ref_view(params, cfg), shard=shards)
        new_state = {"params": params, "opt": new_opt, "step": state["step"] + 1}
        return new_state, {"loss": loss, **metrics}

    train_step.tp = tp
    return train_step
