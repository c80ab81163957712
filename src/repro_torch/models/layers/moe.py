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
reference's two ``shard_map`` paths and its GSPMD one, each rank holding
its experts:

* **routed EP** (``_moe_routed_ep``): experts split over ``model``;
  tokens stay on their data rank and are replicated over ``model``;
  each rank dispatches to its local experts only
  (``_dispatch_combine_local``, capacity from its data row's token
  count) and the combine is one sum over ``model``.  The reference
  splits each global chunk over the data ranks; cutting each row's own
  stream in pieces of ``chunk / n_data`` gives the same blocks of the
  global stream at the same capacity, computed on other ranks;
* **no expert parallelism** (experts whole, or their hidden width split
  over ``model``): the single device's dispatch of each *global* chunk,
  which the reference leaves to GSPMD.  An assignment's fate depends
  only on the assignments before it in its chunk, so the data rows
  all-gather their per-chunk expert counts (``_global_chunks``) and
  each row dispatches its own tokens at the global chunk's capacity,
  offset by the chunk's assignments on the rows before it;
* **2-D EP** (``_moe_grouped_ep2d``, ``cfg.moe_group_limit > 0`` and
  ``experts`` over ``(data, model)``): each data row routes its tokens
  within its own ``E / n_data`` experts, so no token leaves its row and
  the combine is again one sum over ``model``;
* **experts over ``(data, model)`` without a group limit**
  (``_moe_global``): the single device's computation, which the
  reference leaves to GSPMD.  Each chunk of the *global* token stream
  (capacity from the global chunk's token count) is gathered over the
  batch axes with its gates and expert ids, every rank dispatches it to
  its ``E / (n_data n_model)`` experts, and the partial outputs are
  summed over ``data`` (this row's rows kept) and over ``model``.

Dispatch and gate enter the split computation through
``sharding.block_in`` (their gradients are the ranks' partial sums) and
the combine is ``sharding.block_out`` (a sum over ``model``, or under
sequence parallelism a reduce-scatter along the sequence); the router
and its load-balance loss stay replicated.
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


def _own(t: torch.Tensor, seq) -> torch.Tensor:
    """Rows of ``t`` [B*S, ...] that this rank counts in a sum over the
    batch: all of them, or under sequence parallelism (the whole
    sequence on every ``model`` rank) its block of the sequence."""
    if seq is None or not shlib.sp_active():
        return t
    B, S = seq
    return shlib.seq_cut(t.reshape(B, S, -1)).reshape(-1, t.shape[-1])


def _route(params, x: torch.Tensor, cfg, want_aux: bool = True, seq=None):
    """x [T,D] -> (gate [T,k] fp32, idx [T,k] int64, aux_loss scalar, or
    None without ``want_aux``: decode needs no loss, nor its sums over
    the batch axes).  ``seq``: ``(B, S)`` of the tokens, whose sums run
    over each rank's block of the sequence under sequence parallelism
    (and over ``model`` with the batch axes)."""
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
    if shlib.sp_active():
        axes = axes + ("model",)
        probs, hot = _own(probs, seq), _own(hot, seq)
    if axes:  # the means over the whole batch, as the reference takes them
        n = shlib.all_sum(torch.tensor(float(probs.shape[0]), device=x.device),
                          axes)
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
                            cap_experts: int = 0, n_tokens: int = 0,
                            before: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Capacity-buffered compute of the LOCAL expert slice [e0, e0+e_loc)
    (all experts: ``_dispatch_combine``).

    Assignments to other experts are dropped here (their own rank
    computes them); every gather and scatter indexes local data only.
    ``cap_experts``: expert-pool size for the capacity formula (the
    routing pool may be smaller than num_experts under group limits).
    ``n_tokens``: the token count of the capacity formula (default:
    ``x``'s); ``before`` [E]: each expert's assignments that precede
    ``x``'s in its group (on other ranks), which take its slots first."""
    T, D = x.shape
    k = cfg.experts_per_token
    C = _capacity(n_tokens or T, cfg, cap_experts)
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
    # the slots the group's earlier assignments took
    taken = 0 if before is None else before[e0: e0 + e_loc][sorted_e.clamp(0, e_loc - 1)]
    keep = (sorted_e < e_loc) & (pos_in_e + taken < C)
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
    """If a training mesh splits the experts over ``model`` alone (more
    than one rank), return (mesh, n_model) for the routed EP path, else
    None (2D-sharded experts take the grouped or the global path)."""
    mesh, _ = shlib.active_rules()
    if mesh is None or _expert_axes(cfg) != ("model",):
        return None
    n_model = mesh.shape["model"]
    return (mesh, n_model) if n_model > 1 else None


def _moe_routed_ep(params, xt, gate, idx, cfg, mesh, n_model):
    """Routed EP: experts split over ``model``; this rank's tokens are
    replicated over ``model``; the partial outputs of its experts (the
    caller sums them over ``model``)."""
    e_loc = cfg.num_experts // n_model
    return _dispatch_combine_local(
        _expert_params(params), shlib.block_in(xt), shlib.block_in(gate),
        idx, cfg, e0=mesh.coord("model") * e_loc, e_loc=e_loc)


def _global_chunks(idx: torch.Tensor, chunk: int, cfg, mesh, rules):
    """The single device's chunks of the global token stream, as they
    fall on this data row: ``[(a, b, n, before)]``, this row's tokens
    ``[a, b)`` of one global chunk of ``n`` tokens, and ``before`` [E]
    the chunk's assignments to each expert on the data rows before this
    one (None off a data-split mesh).  Row ``r`` of ``n_rows`` holds the
    global tokens ``[r T_loc, (r + 1) T_loc)``, each row's counts per
    (chunk, expert) come from one all-gather of ``[chunks, E]`` ints."""
    T_loc = idx.shape[0]
    owners = shlib.batch_axes(mesh, rules) if mesh is not None else ()
    n_rows = mesh.extent(owners) if owners else 1
    if n_rows == 1:
        return [(i, i + chunk, chunk, None) for i in range(0, T_loc, chunk)]
    E = cfg.num_experts
    lo = mesh.coord(owners) * T_loc
    n_chunks = T_loc * n_rows // chunk
    chunk_of = (lo + torch.arange(T_loc, device=idx.device)) // chunk
    hist = torch.zeros(n_chunks * E, dtype=torch.int64, device=idx.device)
    hist.scatter_add_(0, (chunk_of[:, None] * E + idx).reshape(-1),
                      torch.ones(idx.numel(), dtype=torch.int64,
                                 device=idx.device))
    rows = shlib.gather_dim(hist[None], 0, owners)  # [n_rows, chunks * E]
    before = rows[: mesh.coord(owners)].sum(0).reshape(n_chunks, E)
    out = []
    for c in range(n_chunks):
        a, b = max(lo, c * chunk), min(lo + T_loc, (c + 1) * chunk)
        if a < b:
            out.append((a - lo, b - lo, chunk, before[c]))
    return out


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


def _moe_grouped_ep2d(params, xt, cfg, mesh, nd, nm, want_aux: bool = True,
                      seq=None):
    """Group-limited routing over 2D-sharded experts.

    Tokens route ONLY to the E/nd experts of their own data row, so no
    token crosses the ``data`` axis, and the only collective is the
    row's combine sum over ``model``.  Returns (y, aux): y the partial
    outputs of this rank's experts (the caller sums them over ``model``),
    aux the mean over the data rows of each row's load-balance loss."""
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
        _expert_params(params), shlib.block_in(xt), shlib.block_in(gate),
        idx, cfg, e0=col * E_sub, e_loc=E_sub, cap_experts=E_row)
    if not want_aux:
        return y, None
    p_all = torch.softmax(logits, dim=-1)
    hot = (row_ids[idx[:, :1]] == torch.arange(E, device=dev)).float()
    if shlib.sp_active():  # the row's means over each rank's sequence block
        p_all, hot = _own(p_all, seq), _own(hot, seq)
        n = shlib.all_sum(torch.tensor(float(p_all.shape[0]), device=dev),
                          "model")
        me = shlib.reduce(p_all.sum(dim=0), "model") / n
        fe = shlib.all_sum(hot.sum(dim=0), "model") / n
    else:
        me, fe = p_all.mean(dim=0), hot.mean(dim=0)
    aux = E * (me * fe).sum()
    return y, shlib.reduce(aux, "data") / nd


def _expert_axes(cfg) -> Tuple[str, ...]:
    """The mesh axes the active rules split the experts over (resolved
    with divisibility, as their leaves are), or ()."""
    mesh, rules = shlib.active_rules()
    if mesh is None:
        return ()
    return shlib.dim_axes(shlib.spec_for(("experts",), rules, mesh,
                                         (cfg.num_experts,)), 0)


def global_dispatch(cfg, mesh, rules) -> bool:
    """Whether ``rules`` put the experts over a batch axis with no group
    limit (``_moe_global``): each rank then serves every token of the
    global batch, and its expert gradients need no sum over the batch
    axes (``TrainTP.sync_grads``)."""
    if not cfg.num_experts or cfg.moe_group_limit > 0:
        return False
    held = shlib.dim_axes(shlib.spec_for(("experts",), rules, mesh,
                                         (cfg.num_experts,)), 0)
    return bool(set(held) & set(shlib.batch_axes(mesh, rules)))


def _mlp_split(params, cfg) -> bool:
    """Without an expert-parallel path on a training mesh, this rank
    holds every expert; True if it holds a ``model`` block of their
    hidden width (the combine is then a sum over ``model``)."""
    w1 = params["w1"]
    if tuple(w1.shape[:2]) != (cfg.num_experts, cfg.d_model):
        raise NotImplementedError(
            f"{cfg.name}: experts held as {tuple(w1.shape)} of "
            f"{(cfg.num_experts, cfg.d_model, cfg.moe_d_ff)} with no "
            f"expert-parallel path (ROADMAP, Queue A item 4)")
    return w1.shape[-1] != cfg.moe_d_ff


def _moe_global(params, x: torch.Tensor, gate: torch.Tensor,
                idx: torch.Tensor, cfg, chunk_tokens: int,
                held: Tuple[str, ...]) -> torch.Tensor:
    """Experts over ``held`` (batch axes among them) without a group
    limit: the single device's dispatch of the global token stream, in
    chunks of ``chunk_tokens`` of it (the reference's ``scan``), each
    with the capacity of its global token count.

    Each chunk's tokens, gates and ids are gathered over the batch axes
    (``exchange_in``: every rank holds the chunk), dispatched to this
    rank's experts only (``_dispatch_combine_local`` at the global
    capacity), and the partial outputs summed over the expert axes but
    ``model`` (``exchange_out``, this row's rows kept).  Returns the
    partial sums over ``model`` of this rank's rows ``[B, S, D]`` (whole,
    when ``model`` does not split the experts)."""
    mesh, rules = shlib.active_rules()
    B, S, D = x.shape
    k = cfg.experts_per_token
    owners = shlib.batch_axes(mesh, rules)
    nb = mesh.extent(owners) if owners else 1
    rb = mesh.coord(owners) if owners else 0
    e_loc = cfg.num_experts // mesh.extent(held)
    e0 = mesh.coord(held) * e_loc
    summers = tuple(a for a in held if a != "model")
    split = "model" in held
    T_loc = B * S
    T = T_loc * nb  # the global stream: data row rb holds [rb T_loc, ...)
    chunk = min(chunk_tokens, T)
    if T % chunk != 0:
        chunk = T  # smoke shapes: do it in one piece
    xt = x.reshape(T_loc, D)
    if split:
        xt, gate = shlib.block_in(xt), shlib.block_in(gate)
    # gates and expert ids travel together in fp32 (ids < 2^24: exact)
    gi = torch.cat([gate.float(), idx.to(torch.float32)], dim=-1)
    lo, hi = rb * T_loc, (rb + 1) * T_loc
    eparams = _expert_params(params)
    outs = []
    for c0 in range(0, T, chunk):
        a, b = max(lo, c0), min(hi, c0 + chunk)
        a, b = (a, b) if a < b else (c0, c0)  # no rows of this rank in it
        pos = torch.arange(a - c0, b - c0, device=x.device)
        xc = shlib.exchange_in(xt[a - lo: b - lo], pos, chunk, owners, summers)
        gc = shlib.exchange_in(gi[a - lo: b - lo], pos, chunk, owners, summers)
        yc = _dispatch_combine_local(eparams, xc, gc[:, :k], gc[:, k:].long(),
                                     cfg, e0, e_loc, cap_experts=cfg.num_experts)
        outs.append(shlib.exchange_out(yc, pos, summers, owners))
    return torch.cat(outs).reshape(B, S, D)


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
    mesh, rules = shlib.active_rules()

    ep2d = _ep2d_info(cfg)
    if ep2d is not None:
        _, nd, nm = ep2d
        y, aux = _moe_grouped_ep2d(params, xt, cfg, mesh, nd, nm, want_aux,
                                   seq=(B, S))
        return shlib.block_out(y.reshape(B, S, D)), aux

    gate, idx, aux = _route(params, xt, cfg, want_aux, seq=(B, S))
    held = _expert_axes(cfg)
    if mesh is not None and global_dispatch(cfg, mesh, rules):
        y = _moe_global(params, x, gate, idx, cfg, chunk_tokens, held)
        return shlib.block_out(y, partial="model" in held), aux

    T = B * S
    ep = _ep_shard_info(cfg)
    # chunks of the global token stream
    n_rows = mesh.extent(shlib.batch_axes(mesh, rules)) if mesh is not None else 1
    chunk = min(chunk_tokens, T * n_rows)
    if (T * n_rows) % chunk != 0:
        chunk = T * n_rows  # smoke shapes: do it in one piece
    partial = ep is not None or (mesh is not None and _mlp_split(params, cfg))
    if ep is not None:
        # the reference splits each global chunk over the data rows, each
        # slice with its own capacity: the blocks of chunk / n_rows tokens
        # this row's own stream is cut in
        w = chunk // n_rows
        segs = [(i, i + w, w, None) for i in range(0, T, w)]

        def piece(xc, gc, ic, n, before):
            return _moe_routed_ep(params, xc, gc, ic, cfg, *ep)
    else:
        segs = _global_chunks(idx, chunk, cfg, mesh, rules)

        def piece(xc, gc, ic, n, before):
            if partial:
                xc, gc = shlib.block_in(xc), shlib.block_in(gc)
            return _dispatch_combine_local(params, xc, gc, ic, cfg, 0,
                                           cfg.num_experts, n_tokens=n,
                                           before=before)
    y = torch.cat([piece(xt[a:b], gate[a:b], idx[a:b], n, before)
                   for a, b, n, before in segs]).reshape(B, S, D)
    if mesh is not None:
        y = shlib.block_out(y, partial)
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
