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

Expert parallelism on a training mesh (``sharding.axis_rules``), the
reference's two ``shard_map`` paths, each rank holding its experts:

* **routed EP** (``_moe_routed_ep``): experts split over ``model``;
  tokens stay on their data rank and are replicated over ``model``;
  each rank dispatches to its local experts only
  (``_dispatch_combine_local``, capacity from its data row's token
  count) and the combine is one sum over ``model``;
* **2-D EP** (``_moe_grouped_ep2d``, ``cfg.moe_group_limit > 0`` and
  ``experts`` over ``(data, model)``): each data row routes its tokens
  within its own ``E / n_data`` experts, so no token leaves its row and
  the combine is again one sum over ``model``.

Dispatch and gate enter the split computation through
``sharding.enter`` (their gradients are the ranks' partial sums) and the
combine is ``sharding.reduce``; the router and its load-balance loss
stay replicated.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed import sharding as shlib
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


def _capacity(n_tokens: int, cfg, pool: int = 0) -> int:
    """Slots per expert for ``n_tokens`` routed over ``pool`` experts
    (default: all of them)."""
    c = int(n_tokens * cfg.experts_per_token * cfg.capacity_factor
            / (pool or cfg.num_experts))
    return max(8, -(-c // 8) * 8)  # round up to 8, floor at 8


def _route(params, x: torch.Tensor, cfg, want_aux: bool = True):
    """x [T,D] -> (gate [T,k] fp32, idx [T,k] int64, aux_loss scalar, or
    None without ``want_aux``: decode needs no loss, nor its sums over
    the batch axes)."""
    logits = x.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    k = cfg.experts_per_token
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = srt[:, :k], order[:, :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    if not want_aux:
        return gate, idx, None
    # switch-style load-balance aux loss
    E = cfg.num_experts
    # fraction routed (top-1 proxy): the mean of a one-hot, built without
    # the host sync of ``bincount`` / ``one_hot`` on the card
    experts = torch.arange(E, device=idx.device)
    hot = (idx[:, :1] == experts).float()
    mesh, rules = shlib.active_rules()
    axes = shlib.batch_axes(mesh, rules) if mesh is not None else ()
    if axes:  # the means over the whole batch, as the reference takes them
        n = shlib.all_sum(torch.tensor(float(x.shape[0]), device=x.device), axes)
        me = shlib.reduce(probs.sum(dim=0), axes) / n
        fe = shlib.all_sum(hot.sum(dim=0), axes) / n
    else:
        me = probs.mean(dim=0)  # [E] mean router prob
        fe = hot.mean(dim=0)
    aux = E * (me * fe).sum()
    return gate, idx, aux


def _dispatch_combine(params, x: torch.Tensor, gate: torch.Tensor,
                      idx: torch.Tensor, cfg) -> torch.Tensor:
    """Sort-based capacity-buffered expert compute for a token chunk.

    x [T,D], gate/idx [T,k]  ->  y [T,D]"""
    return _dispatch_combine_local(params, x, gate, idx, cfg, 0,
                                   cfg.num_experts)


def _dispatch_combine_local(params_loc, x: torch.Tensor, gate: torch.Tensor,
                            idx: torch.Tensor, cfg, e0: int, e_loc: int,
                            cap_experts: int = 0) -> torch.Tensor:
    """Capacity-buffered compute of the LOCAL expert slice [e0, e0+e_loc)
    (all experts: ``_dispatch_combine``).

    Assignments to other experts are dropped here (their own rank
    computes them); every gather and scatter indexes local data only.
    ``cap_experts``: expert-pool size for the capacity formula (the
    routing pool may be smaller than num_experts under group limits)."""
    T, D = x.shape
    k = cfg.experts_per_token
    C = _capacity(T, cfg, cap_experts)
    dev = x.device

    flat_e = idx.reshape(-1)  # [T*k]
    local = (flat_e >= e0) & (flat_e < e0 + e_loc)
    flat_le = torch.where(local, flat_e - e0,
                          torch.full_like(flat_e, e_loc))  # remote -> overflow id
    order = torch.argsort(flat_le, stable=True)
    sorted_e = flat_le[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e_loc, device=dev),
                                right=False)
    pos_in_e = torch.arange(T * k, device=dev) - starts[sorted_e.clamp(0, e_loc - 1)]
    keep = (sorted_e < e_loc) & (pos_in_e < C)
    dest = torch.where(keep, sorted_e * C + pos_in_e,
                       torch.full_like(pos_in_e, e_loc * C))  # dropped -> slot e_loc*C
    src_token = order // k

    # dispatch: buf[e, c] = x[token routed to (e, c)]; every kept row has
    # its own slot, the dropped ones all land in the discarded slot
    buf = x.new_zeros((e_loc * C + 1, D))
    buf[dest] = x[src_token]
    buf = buf[: e_loc * C].reshape(e_loc, C, D)

    # batched expert products
    act = activation_fn(cfg.activation)
    h1 = torch.bmm(buf, params_loc["w1"])
    if "wg" in params_loc:
        z = act(torch.bmm(buf, params_loc["wg"])) * h1
    else:
        z = act(h1)
    yexp = torch.bmm(z, params_loc["w2"])

    # combine: gather back, weight by gate, add per token.  A token's k
    # assignments sit in ascending expert order along ``order``; adding
    # them in that order from zero is the reference's scatter-add order.
    ypad = torch.cat([yexp.reshape(e_loc * C, D), x.new_zeros((1, D))], 0)
    contrib = ypad[dest] * gate.reshape(-1)[order][:, None].to(x.dtype)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(T * k, device=dev)
    rows = torch.sort(rank.reshape(T, k), dim=1).values
    y = x.new_zeros((T, D))
    for j in range(k):
        y = y + contrib[rows[:, j]]
    return y


def _expert_params(params) -> Dict:
    return {k: params[k] for k in ("w1", "w2", "wg") if k in params}


def _ep_shard_info(cfg):
    """If a training mesh with a usable ``model`` axis is active, return
    (mesh, n_model) for the routed EP path, else None (2D-sharded experts
    take the grouped path or none)."""
    mesh, rules = shlib.active_rules()
    if mesh is None or "model" not in mesh.axis_names:
        return None
    exp_rule = (rules or {}).get("experts")
    if isinstance(exp_rule, tuple) and len(exp_rule) > 1:
        return None
    n_model = mesh.shape["model"]
    if n_model <= 1 or cfg.num_experts % n_model != 0:
        return None
    return mesh, n_model


def _moe_routed_ep(params, xt, gate, idx, cfg, mesh, n_model):
    """Routed EP: experts split over ``model``; this rank's tokens are
    replicated over ``model``; the combine is a sum over ``model``."""
    e_loc = cfg.num_experts // n_model
    y = _dispatch_combine_local(
        _expert_params(params), shlib.enter(xt, "model"),
        shlib.enter(gate, "model"), idx, cfg,
        e0=mesh.coord("model") * e_loc, e_loc=e_loc)
    return shlib.reduce(y, "model")


def _ep2d_info(cfg):
    """Group-limited 2D EP: experts sharded (data, model); usable when
    ``cfg.moe_group_limit > 0`` and the division works out."""
    mesh, rules = shlib.active_rules()
    if mesh is None or cfg.moe_group_limit <= 0:
        return None
    if "model" not in mesh.axis_names or "data" not in mesh.axis_names:
        return None
    exp_rule = (rules or {}).get("experts")
    if not (isinstance(exp_rule, tuple) and set(exp_rule) == {"data", "model"}):
        return None
    nd, nm = mesh.shape["data"], mesh.shape["model"]
    if cfg.num_experts % (nd * nm) != 0:
        return None
    return mesh, nd, nm


def _moe_grouped_ep2d(params, xt, cfg, mesh, nd, nm, want_aux: bool = True):
    """Group-limited routing over 2D-sharded experts.

    Tokens route ONLY to the E/nd experts of their own data row, so no
    token crosses the ``data`` axis, and the only collective is the
    row's combine sum over ``model``.  Returns (y, aux): aux is the mean
    over the data rows of each row's load-balance loss."""
    E = cfg.num_experts
    E_row = E // nd
    E_sub = E_row // nm
    k = cfg.experts_per_token
    row, col = mesh.coord("data"), mesh.coord("model")
    dev = xt.device
    logits = xt.float() @ params["router"]
    row_ids = row * E_row + torch.arange(E_row, device=dev)
    probs = torch.softmax(logits[:, row_ids], dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = srt[:, :k], order[:, :k]  # idx in [0, E_row)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    y = _dispatch_combine_local(
        _expert_params(params), shlib.enter(xt, "model"),
        shlib.enter(gate, "model"), idx, cfg, e0=col * E_sub, e_loc=E_sub,
        cap_experts=E_row)
    y = shlib.reduce(y, "model")
    if not want_aux:
        return y, None
    me = torch.softmax(logits, dim=-1).mean(dim=0)
    fe = (row_ids[idx[:, :1]] == torch.arange(E, device=dev)).float().mean(dim=0)
    aux = E * (me * fe).sum()
    return y, shlib.reduce(aux, "data") / nd


def _mlp_split(params, cfg) -> bool:
    """Without an EP path on a training mesh, this rank must hold every
    expert; True if it holds a ``model`` block of their hidden width (the
    combine is then a sum over ``model``)."""
    w1 = params["w1"]
    if tuple(w1.shape[:2]) != (cfg.num_experts, cfg.d_model):
        raise NotImplementedError(
            f"{cfg.name}: experts held as {tuple(w1.shape)} of "
            f"{(cfg.num_experts, cfg.d_model, cfg.moe_d_ff)} with no "
            f"expert-parallel path (routed EP needs experts over 'model' "
            f"dividing {cfg.num_experts}; experts over (data, model) need "
            f"moe_group_limit > 0; ROADMAP, Queue A item 4)")
    return w1.shape[-1] != cfg.moe_d_ff


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
    chunks of ``chunk_tokens`` (one piece when it does not divide).  On
    a training mesh this rank's tokens are its data row's, and the
    expert-parallel paths apply (module docstring)."""
    y, aux = _routed(params, x, cfg, chunk_tokens)
    stats = None
    if "shared" in params:
        Fs = cfg.moe_d_ff * cfg.num_shared_experts
        ys, stats = ffn_lib.ffn_forward(params["shared"], x, cfg,
                                        collect_stats=collect_stats,
                                        want_z=want_z, d_ff=Fs)
        y = y + ys
    return y, aux, stats


def _routed(params: Dict, x: torch.Tensor, cfg, chunk_tokens: int = 16_384,
            want_aux: bool = True):
    """The routed experts of ``moe_forward``: ``(y [B,S,D], aux)``."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)

    ep2d = _ep2d_info(cfg)
    if ep2d is not None:
        mesh, nd, nm = ep2d
        y, aux = _moe_grouped_ep2d(params, xt, cfg, mesh, nd, nm, want_aux)
        return y.reshape(B, S, D), aux

    gate, idx, aux = _route(params, xt, cfg, want_aux)

    T = B * S
    ep = _ep_shard_info(cfg)
    mesh, rules = shlib.active_rules()
    # chunks of the global token stream, each split over the data ranks
    n_rows = mesh.extent(shlib.batch_axes(mesh, rules)) if mesh is not None else 1
    chunk = min(chunk_tokens, T * n_rows)
    if (T * n_rows) % chunk != 0:
        chunk = T * n_rows  # smoke shapes: do it in one piece
    chunk //= n_rows
    if ep is not None:
        def piece(xc, gc, ic):
            return _moe_routed_ep(params, xc, gc, ic, cfg, *ep)
    elif mesh is not None and _mlp_split(params, cfg):
        def piece(xc, gc, ic):
            return shlib.reduce(_dispatch_combine(
                params, shlib.enter(xc, "model"), shlib.enter(gc, "model"),
                ic, cfg), "model")
    else:
        def piece(xc, gc, ic):
            return _dispatch_combine(params, xc, gc, ic, cfg)
    y = torch.cat([piece(xt[i : i + chunk], gate[i : i + chunk],
                         idx[i : i + chunk])
                   for i in range(0, T, chunk)]).reshape(B, S, D)
    return y, aux


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
    mesh, _ = shlib.active_rules()
    if mesh is not None:  # a serving mesh: the training forward's EP paths
        y, _ = _routed(params, x, cfg, want_aux=False)
        if pruned_shared is not None:
            ys, _ = ffn_lib.ffn_forward(
                pruned_shared, x, cfg,
                d_ff=ffn_lib.mesh_width(pruned_shared["w1"].shape[-1]))
            y = y + ys
        elif "shared" in params:
            ys, _ = ffn_lib.ffn_forward(
                params["shared"], x, cfg,
                d_ff=cfg.moe_d_ff * cfg.num_shared_experts)
            y = y + ys
        return y
    xt = x.reshape(B * S, D)
    gate, idx, _ = _route(params, xt, cfg)
    y = _dispatch_combine(params, xt, gate, idx, cfg).reshape(B, S, D)
    shared = pruned_shared if pruned_shared is not None else params.get("shared")
    if shared is not None:
        ys, _ = ffn_lib.ffn_forward(shared, x, cfg)
        y = y + ys
    return y
