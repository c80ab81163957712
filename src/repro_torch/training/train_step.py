"""Train-step builder: microbatch gradient accumulation + remat +
optimizer application (port of ``repro/training/train_step.py``).

A train state is a plain dict: ``params`` in the port's per-layer
layout, ``opt`` in the reference's scan-stacked layout (see
``optimizer.py``; the optimizer sees the parameters through
``bridge.ref_view``, which copies nothing) and ``step`` an int32 tensor.
``bridge.train_state_to_jax`` / ``train_state_from_jax`` carry it to and
from the reference's layout for checkpoints.  The step updates the
parameters and the optimizer state in place.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import bridge
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


def _flatten(tree: Any) -> Tuple[List[torch.Tensor], Callable]:
    """Tensors of a dict/list tree in order, and a function that builds
    the same tree from a list of new leaves."""
    leaves: List[torch.Tensor] = []

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        leaves.append(t)
        return len(leaves) - 1

    skeleton = walk(tree)

    def rebuild(vals):
        def fill(s):
            if isinstance(s, dict):
                return {k: fill(v) for k, v in s.items()}
            if isinstance(s, list):
                return [fill(v) for v in s]
            return vals[s]
        return fill(skeleton)

    return leaves, rebuild


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


def build_train_step(
    cfg,
    optimizer: Optimizer,
    accum_steps: int = 1,
    loss_fn: Optional[Callable] = None,
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    ``batch`` holds tensors on the parameters' device.  ``accum_steps >
    1`` splits the batch into that many microbatches along its first
    axis and accumulates their gradients in fp32 (the activation-memory
    lever for the big configs); gradients and loss are then divided by
    ``accum_steps`` and the metrics are the loss alone.
    """
    loss_fn = loss_fn or decoder.loss_fn

    def grads_of(params, mb):
        loss, metrics, grads = value_and_grad(loss_fn, params, mb, cfg)
        flat, rebuild = _flatten(params)
        gflat, _ = _flatten(grads)
        gflat = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, gflat)]
        return rebuild(gflat), loss, metrics

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        if accum_steps == 1:
            grads, loss, metrics = grads_of(params, batch)
        else:
            flat, rebuild = _flatten(params)
            g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in flat]
            loss = torch.zeros((), dtype=torch.float32, device=flat[0].device)
            mbs = {k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                                *v.shape[1:]) for k, v in batch.items()}
            for i in range(accum_steps):
                g, l, _ = grads_of(params, {k: v[i] for k, v in mbs.items()})
                g_acc = [a + b.to(torch.float32)
                         for a, b in zip(g_acc, _flatten(g)[0])]
                loss = loss + l
            grads = rebuild([g / accum_steps for g in g_acc])
            loss = loss / accum_steps
            metrics = {}

        _, new_opt = optimizer.update(bridge.ref_view(grads, cfg), state["opt"],
                                      bridge.ref_view(params, cfg))
        new_state = {"params": params, "opt": new_opt, "step": state["step"] + 1}
        return new_state, {"loss": loss, **metrics}

    return train_step
