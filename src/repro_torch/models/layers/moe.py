"""Mixture-of-Experts FF block: top-k routing, sort-based capacity
dispatch, batched expert products, optional shared experts (port of
``repro/models/layers/moe.py``).

Dispatch is **sort-based**: assignments are argsorted by expert id, each
expert's group start found by ``searchsorted``, and every expert gets a
static capacity ``C`` of rows.  Assignments beyond an expert's capacity
are dropped (the residual path carries them).  The expert products run
over all ``E`` experts at that capacity, empty or not, as the
reference's einsums do.  Long token streams are dispatched in chunks of
``chunk_tokens``, each with its own capacity.

GRIFFIN's statistic is collected on the **shared experts** (the always-on
dense FF): routed experts are already adaptively sparse.

Ported as the reference has it, with two points made explicit:

* ties: ``jax.lax.top_k`` prefers the lower index, and so does a stable
  descending sort; ``torch.topk`` promises no order;
* the combine adds each token's ``k`` contributions one by one, in
  ascending expert order from zero, in the activation dtype — the order
  of the reference's serial scatter-add.  ``index_add_`` on the card
  adds with atomics, so its order (and a bf16 stream) could change from
  run to run.

The reference's expert-parallel paths (``shard_map`` over a mesh) are
not ported: they belong with tensor parallelism.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.common import activation_fn
from repro_torch.models.layers import ffn as ffn_lib
from repro_torch.models.param import ParamSpec


def moe_specs(cfg) -> Dict[str, ParamSpec]:
    D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    specs = {
        "router": ParamSpec((D, E), ("embed", None), dtype="float32"),
        "w1": ParamSpec((E, D, F), ("experts", "embed", "mlp")),
        "w2": ParamSpec((E, F, D), ("experts", "mlp", "embed")),
    }
    if cfg.glu:
        specs["wg"] = ParamSpec((E, D, F), ("experts", "embed", "mlp"))
    if cfg.num_shared_experts:
        Fs = cfg.moe_d_ff * cfg.num_shared_experts
        specs["shared"] = ffn_lib.ffn_specs(cfg, d_ff=Fs)
    return specs


def _capacity(n_tokens: int, cfg) -> int:
    c = int(n_tokens * cfg.experts_per_token * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8, floor at 8


def _route(params, x: torch.Tensor, cfg):
    """x [T,D] -> (gate [T,k] fp32, idx [T,k] int64, aux_loss scalar)."""
    logits = x.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    k = cfg.experts_per_token
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = srt[:, :k], order[:, :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # switch-style load-balance aux loss
    E = cfg.num_experts
    me = probs.mean(dim=0)  # [E] mean router prob
    # fraction routed (top-1 proxy): the mean of a one-hot, built without
    # the host sync of ``bincount`` / ``one_hot`` on the card
    experts = torch.arange(E, device=idx.device)
    fe = (idx[:, :1] == experts).float().mean(dim=0)
    aux = E * (me * fe).sum()
    return gate, idx, aux


def _dispatch_combine(params, x: torch.Tensor, gate: torch.Tensor,
                      idx: torch.Tensor, cfg) -> torch.Tensor:
    """Sort-based capacity-buffered expert compute for a token chunk.

    x [T,D], gate/idx [T,k]  ->  y [T,D]"""
    T, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = _capacity(T, cfg)
    dev = x.device

    flat_e = idx.reshape(-1)  # [T*k]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev), right=False)
    pos_in_e = torch.arange(T * k, device=dev) - starts[sorted_e]
    keep = pos_in_e < C
    dest = torch.where(keep, sorted_e * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))  # overflow -> slot E*C
    src_token = order // k

    # dispatch: buf[e, c] = x[token routed to (e, c)]; every kept row has
    # its own slot, the dropped ones all land in the discarded slot E*C
    buf = x.new_zeros((E * C + 1, D))
    buf[dest] = x[src_token]
    buf = buf[: E * C].reshape(E, C, D)

    # batched expert products
    act = activation_fn(cfg.activation)
    h1 = torch.bmm(buf, params["w1"])
    if "wg" in params:
        z = act(torch.bmm(buf, params["wg"])) * h1
    else:
        z = act(h1)
    yexp = torch.bmm(z, params["w2"])

    # combine: gather back, weight by gate, add per token.  A token's k
    # assignments sit in ascending expert order along ``order``; adding
    # them in that order from zero is the reference's scatter-add order.
    ypad = torch.cat([yexp.reshape(E * C, D), x.new_zeros((1, D))], 0)
    contrib = ypad[dest] * gate.reshape(-1)[order][:, None].to(x.dtype)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(T * k, device=dev)
    rows = torch.sort(rank.reshape(T, k), dim=1).values
    y = x.new_zeros((T, D))
    for j in range(k):
        y = y + contrib[rows[:, j]]
    return y


def moe_forward(
    params: Dict,
    x: torch.Tensor,
    cfg,
    chunk_tokens: int = 16_384,
    collect_stats: bool = False,
    want_z: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """x: [B,S,D] -> (y [B,S,D], aux_loss, shared-expert stats or None).

    Routing runs over all ``B*S`` tokens at once; the dispatch over
    chunks of ``chunk_tokens`` (one piece when it does not divide)."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    gate, idx, aux = _route(params, xt, cfg)

    T = B * S
    chunk = min(chunk_tokens, T)
    if T % chunk != 0:
        chunk = T  # smoke shapes: do it in one piece
    y = torch.cat([
        _dispatch_combine(params, xt[i : i + chunk], gate[i : i + chunk],
                          idx[i : i + chunk], cfg)
        for i in range(0, T, chunk)
    ]).reshape(B, S, D)

    stats = None
    if "shared" in params:
        ys, stats = ffn_lib.ffn_forward(params["shared"], x, cfg,
                                        collect_stats=collect_stats,
                                        want_z=want_z)
        y = y + ys
    return y, aux, stats


def moe_decode(
    params: Dict,
    pruned_shared: Optional[Dict],
    x: torch.Tensor,
    cfg,
) -> torch.Tensor:
    """Decode-phase MoE: routed experts as usual (all ``B*S`` tokens one
    dispatch); the shared experts optionally replaced by their
    GRIFFIN-compacted block."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    gate, idx, _ = _route(params, xt, cfg)
    y = _dispatch_combine(params, xt, gate, idx, cfg).reshape(B, S, D)
    shared = pruned_shared if pruned_shared is not None else params.get("shared")
    if shared is not None:
        ys, _ = ffn_lib.ffn_forward(shared, x, cfg)
        y = y + ys
    return y
