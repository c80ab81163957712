"""Model assembly for every architecture family: dense, MoE and MLA
attention, Mamba-2 (SSD), the RG-LRU + local-attention hybrid, the
bidirectional encoder and the VLM backbone, whose modality frontends are
stubs fed precomputed ``prefix_emb`` (port of ``repro/models/decoder.py``:
the contiguous prefill/decode path, the paged serving path, which covers
the dense GQA families without a frontend only, and the training loss).

The reference stacks homogeneous runs of layers on a leading axis and
scans them (``seg{i}/pos{j}`` leaves).  PyTorch runs eagerly, so the
port keeps **one entry per layer**: ``params["layers"][li]``, one pool
dict per layer, and GRIFFIN trees keyed by layer index.  ``build_plan``
is kept to name each layer's place in the reference layout
(``layer_paths``), which the weight bridge and sparsity profiles use.

Public API:

    build_plan(cfg)                          -> [Segment]
    model_specs(cfg)                         -> ParamSpec tree
    init_params(cfg, seed, device)           -> params
    abstract_params(cfg)                     -> params on the meta device
    forward(params, cfg, tokens, ...)        -> logits, Aux (no autograd)
    hidden_forward(params, cfg, tokens, ...) -> hidden states, Aux (autograd)
    loss_fn(params, batch, cfg)              -> loss, metrics (autograd)
    cache_specs(cfg, batch, max_len)         -> ParamSpec list (decode cache)
    kv_specs(cfg, batch, seq)                -> ParamSpec list (prefill KV)
    serve_specs(cfg, specs, mesh, rules)     -> resolved specs on a serving mesh
    init_cache(cfg, batch, max_len, device)  -> cache
    fill_cache_from_prefill(cfg, cache, kv)  -> cache
    recurrent_state(cfg, cache) / restore_recurrent_state(cache, saved)
    decode_step(params, cfg, cache, token, pos, pruned=None) -> logits, cache
    init_paged_pools(cfg, num_pages, page_size, kv_dtype, device) -> pools
    copy_pool_pages(cfg, pools, src, dst)    -> pools (COW page forks)
    decode_step_paged(params, cfg, pools, bt, tokens, pos, ...) -> logits, pools, stats
    draft_loop_paged(params, cfg, pools, bt, token, pos, k_r, ...) -> drafts, pools
    verify_step_paged(params, cfg, pools, bt, tokens, pos, mask, ...) -> logits, pools
    draft_verify_paged(params, cfg, pools, bt, token, pos, k_r, live, ...)
                                             -> drafts, logits, pools
    extract_ffn_tree(params, cfg)            -> {li: dense-FF / MoE shared params}
    pruned_ffn_specs(cfg, sparsity)          -> {li: compacted FF ParamSpecs}
    prune_stats_tree(stats, cfg)             -> {li: stats}
    train_specs(cfg, mesh, rules)            -> resolved spec tree (training mesh)

On a training mesh (``sharding.axis_rules``) ``hidden_forward`` and
``loss_fn`` run one rank's shard: parameters are this rank's blocks of
``train_specs``; each layer gathers its FSDP (``embed`` over ``data``)
leaves inside the layer (so remat gathers them again in the
recompute), the layers place their ``model`` collectives by the blocks
they hold, and the loss is the global one (``chunked_ce``).  Where the
rules put ``seq`` on ``model`` (``make_rules(seq_parallel=True)``) and
the length divides, the residual stream between blocks is this rank's
block of the sequence (``sharding.seq_gather`` before each block, its
``block_out`` after it; the loss in ``_ce_sp``).
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.sharding import psum_if_tp
from repro_torch.kernels import backend as backend_lib
from repro_torch.kernels import kv_quant
from repro_torch.kernels import paged_attn as paged_attn_lib
from repro_torch.models import param as param_lib
from repro_torch.models.common import (
    apply_norm,
    embed_lookup,
    embed_specs,
    head_specs,
    lm_logits,
    norm_specs,
    rope_cos_sin,
)
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers import ffn as ffn_lib
from repro_torch.models.layers import mla as mla_lib
from repro_torch.models.layers import moe as moe_lib
from repro_torch.models.layers import rglru as rglru_lib
from repro_torch.models.layers import ssm as ssm_lib
from repro_torch.models.param import ParamSpec


# ---------------------------------------------------------------------------
# Stack planning
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LayerDesc:
    mixer: str  # "attn" | "ssm" | "rec"
    attn_kind: str  # "global" | "local" | ""
    ffn: str  # "dense" | "moe" | "none"


@dataclass(frozen=True)
class Segment:
    kind: str  # "scan" | "unroll"
    descs: Tuple[LayerDesc, ...]  # per position (scan period) or per layer
    n: int  # number of periods (scan) / layers (unroll == len(descs))


def layer_descs(cfg) -> List[LayerDesc]:
    descs = []
    for li in range(cfg.num_layers):
        mixer = cfg.layer_mixer_kind(li)
        akind = cfg.attn_kind(li) if mixer == "attn" else ""
        if cfg.num_experts and li >= cfg.num_dense_layers:
            f = "moe"
        elif cfg.d_ff > 0:
            f = "dense"
        else:
            f = "none"
        descs.append(LayerDesc(mixer, akind, f))
    return descs


def build_plan(cfg) -> List[Segment]:
    descs = layer_descs(cfg)
    L = cfg.num_layers
    start = cfg.num_dense_layers if cfg.num_experts else 0
    p = max(len(cfg.attn_pattern), 1)
    if cfg.block_pattern:
        p = max(p, len(cfg.block_pattern))
    segments: List[Segment] = []
    if start:
        segments.append(Segment("unroll", tuple(descs[:start]), start))
    n_scan = (L - start) // p
    if n_scan > 0:
        segments.append(Segment("scan", tuple(descs[start : start + p]), n_scan))
    rem = descs[start + n_scan * p :]
    if rem:
        segments.append(Segment("unroll", tuple(rem), len(rem)))
    return segments


def layer_paths(cfg) -> List[Tuple[str, int, int]]:
    """For each layer ``li``: ``(path, instance, n_instances)`` of its
    place in the reference layout — ``"seg{i}/pos{j}"`` with the scan
    period index, or ``"seg{i}/layer{j}"`` with instance 0 of 1."""
    out: List[Tuple[str, int, int]] = []
    for i, seg in enumerate(build_plan(cfg)):
        if seg.kind == "scan":
            p = len(seg.descs)
            out.extend((f"seg{i}/pos{r % p}", r // p, seg.n)
                       for r in range(seg.n * p))
        else:
            out.extend((f"seg{i}/layer{j}", 0, 1) for j in range(seg.n))
    return out


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

def _mixer_specs(cfg, desc: LayerDesc) -> Dict:
    if desc.mixer == "attn":
        return mla_lib.mla_specs(cfg) if cfg.use_mla else attn_lib.attn_specs(cfg)
    if desc.mixer == "ssm":
        return ssm_lib.ssm_specs(cfg)
    return rglru_lib.rglru_specs(cfg)


def layer_specs(cfg, desc: LayerDesc) -> Dict:
    s: Dict[str, Any] = {
        "mixer_norm": norm_specs(cfg),
        "mixer": _mixer_specs(cfg, desc),
    }
    if desc.ffn == "dense":
        s["ffn_norm"] = norm_specs(cfg)
        s["ffn"] = ffn_lib.ffn_specs(cfg)
    elif desc.ffn == "moe":
        s["ffn_norm"] = norm_specs(cfg)
        s["ffn"] = moe_lib.moe_specs(cfg)
    return s


def model_specs(cfg) -> Dict:
    specs: Dict[str, Any] = {"embed": embed_specs(cfg)}
    hs = head_specs(cfg)
    if hs:
        specs["head"] = hs
    if cfg.frontend:
        # the stub frontend's projection of the precomputed embeddings
        specs["frontend"] = {
            "proj": ParamSpec((cfg.d_model, cfg.d_model), ("embed", "act_embed"))
        }
    specs["layers"] = [layer_specs(cfg, d) for d in layer_descs(cfg)]
    specs["final_norm"] = norm_specs(cfg)
    if cfg.mtp_depth:
        # DeepSeek-style MTP module: shared embed/head, 1 extra block.  No
        # serving path reads it (its loss is a training term).
        specs["mtp"] = {
            "norm_h": norm_specs(cfg),
            "norm_e": norm_specs(cfg),
            "proj": ParamSpec((2 * cfg.d_model, cfg.d_model), (None, "embed")),
            "layer": layer_specs(cfg, layer_descs(cfg)[-1]),
        }
    return specs


def abstract_params(cfg) -> Dict:
    """The parameters' shapes and dtypes as ``meta`` tensors (no
    allocation)."""
    return param_lib.abstract_params(model_specs(cfg), cfg.dtype)


def init_params(cfg, seed: int = 0, device=None) -> Dict:
    """Random parameters from ``seed`` on ``device`` (default: the card;
    raises without one unless ``device="cpu"``)."""
    dev = backend_lib.resolve_device(device)
    return param_lib.init_params(model_specs(cfg), seed, cfg.dtype, dev)


# ---------------------------------------------------------------------------
# Training-mesh layout
# ---------------------------------------------------------------------------

def train_specs(cfg, mesh, rules) -> Dict:
    """The resolved spec of every parameter on a training mesh
    (``sharding.tree_specs`` of ``model_specs``)."""
    return shlib.tree_specs(model_specs(cfg), mesh, rules)


def _gather_dims(spec_tree, resolved) -> Any:
    """Per leaf, ``(dim, full size)`` of the dimension FSDP gathers over
    ``data`` (a dimension whose resolved spec holds ``data`` for any
    logical axis but ``experts``, which expert parallelism consumes where
    it lies), or None."""
    def leaf(ps, rs):
        for d, (ax, r) in enumerate(zip(ps.axes, tuple(rs) + (None,) * len(ps.axes))):
            names = (r,) if isinstance(r, str) else (r or ())
            if "data" in names and ax != "experts":
                return d, ps.shape[d]
        return None

    def walk(ps, rs):
        if isinstance(ps, dict):
            return {k: walk(ps[k], rs[k]) for k in ps}
        if isinstance(ps, list):
            return [walk(a, b) for a, b in zip(ps, rs)]
        return leaf(ps, rs)

    return walk(spec_tree, resolved)


@functools.lru_cache(maxsize=16)
def _specs(cfg, axes, dims, rules_items) -> Dict:
    from repro_torch.launch.mesh import abstract_train_mesh

    return train_specs(cfg, abstract_train_mesh(dims, axes), dict(rules_items))


@functools.lru_cache(maxsize=16)
def _plan(cfg, axes, dims, rules_items) -> Dict:
    return _gather_dims(model_specs(cfg), _specs(cfg, axes, dims, rules_items))


def _mesh_specs(cfg) -> Optional[Dict]:
    """``train_specs`` on the active mesh (the layout of every parameter
    block), or None outside one."""
    mesh, rules = shlib.active_rules()
    if mesh is None:
        return None
    return _specs(cfg, mesh.axes, mesh.dims, tuple(sorted(rules.items())))


def _mesh_plan(cfg) -> Optional[Dict]:
    """The FSDP gather dims of every leaf on the active training mesh, or
    None outside one."""
    mesh, rules = shlib.active_rules()
    if mesh is None:
        return None
    return _plan(cfg, mesh.axes, mesh.dims, tuple(sorted(rules.items())))


def _blocked(t, g) -> bool:
    return g is not None and t.shape[g[0]] != g[1]


def _collect(t, g, out: List) -> List:
    """``out`` with ``(leaf, gather dim)`` of every leaf of ``t`` that
    holds only its block (``_gather``)."""
    if g is None:
        return out
    if isinstance(t, (dict, list)):
        for k in (t if isinstance(t, dict) else range(len(t))):
            _collect(t[k], g[k], out)
    elif _blocked(t, g):
        out.append((t, g[0]))
    return out


def _rebuild(t, g, full: Iterator) -> Any:
    """``t`` with each leaf that holds only its block taken from ``full``."""
    if g is None:
        return t
    if isinstance(t, dict):
        return {k: _rebuild(v, g[k], full) for k, v in t.items()}
    if isinstance(t, list):
        return [_rebuild(v, g[i], full) for i, v in enumerate(t)]
    return next(full) if _blocked(t, g) else t


def _gather(tree: Any, gdims: Any) -> Any:
    """``tree`` with every leaf that has a gather dim, and holds only its
    block of it, gathered over ``data`` (one collective per dtype;
    ``sharding.gather``); a None in ``gdims`` leaves its subtree as is.
    The walks are module functions: a recursive closure is a reference
    cycle, which would hold a layer's gathered leaves until Python's
    cyclic collector ran."""
    todo = _collect(tree, gdims, [])
    if not todo:
        return tree
    full = iter(shlib.gather([t for t, _ in todo], [d for _, d in todo], "data"))
    return _rebuild(tree, gdims, full)


def _gather_top(params: Dict, cfg) -> Dict:
    """``params`` with the leaves outside the layer stack gathered (the
    embedding table, head, final norm, frontend; the MTP block's own
    leaves but not its layer), on a training mesh; else ``params``.
    Leaves already gathered pass through."""
    plan = _mesh_plan(cfg)
    if plan is None:
        return params
    return _gather(params, dict(plan, layers=None,
                                **({"mtp": dict(plan["mtp"], layer=None)}
                                   if "mtp" in plan else {})))


# ---------------------------------------------------------------------------
# Aux container
# ---------------------------------------------------------------------------

@dataclass
class Aux:
    """Per-forward side outputs, per layer: ``kv`` a list of ``{k, v}``
    (MLA: ``{ckv, kr}``; SSM: ``{state, conv}``; RG-LRU: ``{h, conv}``:
    prefill cache material), ``stats`` ``{li: {s_sq
    [B,F], x_sq [D], z_sq [F], (z [B,S,F])}}`` for the layers with a
    dense FF block or MoE shared experts, ``moe_aux`` the routers'
    load-balance losses summed over layers (fp32 scalar).  The
    reference's ``x_norms``/``z_norms`` are never set (the Adaptive Wanda
    norms are ``stats``' ``x_sq``/``z_sq``)."""
    kv: Optional[List[Dict]] = None
    stats: Optional[Dict[int, Dict]] = None
    moe_aux: Any = 0.0


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill / teacher-forced evaluation)
# ---------------------------------------------------------------------------

def _rope_width(cfg) -> int:
    """Dims RoPE rotates per head: MLA rotates only its rope part."""
    return cfg.qk_rope_head_dim if cfg.use_mla else cfg.head_dim


def _apply_layer(
    lp: Dict,
    desc: LayerDesc,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg,
    collect_stats: bool,
    q_chunk: int,
    pruned_ffn: Optional[Dict] = None,
    want_z: bool = False,
    rope=None,
    gdims=None,
):
    lp = _gather(lp, gdims)  # FSDP: this layer's weights, inside the layer
    # sequence parallelism: x is this rank's block of the sequence; each
    # block reads the whole of it and hands back its block (block_out)
    whole = shlib.seq_gather if shlib.sp_active() else (lambda t: t)
    h = whole(apply_norm(lp["mixer_norm"], x, cfg))
    if desc.mixer == "ssm":
        y, kv = ssm_lib.ssm_forward(lp["mixer"], h, cfg)
    elif desc.mixer == "rec":
        y, kv = rglru_lib.rglru_forward(lp["mixer"], h, cfg)
    elif cfg.use_mla:
        y, (ckv, kr) = mla_lib.mla_forward(lp["mixer"], h, positions, cfg,
                                           q_chunk, rope=rope)
        kv = {"ckv": ckv, "kr": kr}
    else:
        y, (k, v) = attn_lib.attn_forward(lp["mixer"], h, positions, cfg,
                                          kind=desc.attn_kind, q_chunk=q_chunk,
                                          rope=rope)
        kv = {"k": k, "v": v}
    x = x + y
    stats, aux = None, None
    if desc.ffn != "none":
        h = whole(apply_norm(lp["ffn_norm"], x, cfg))
        if desc.ffn == "dense":
            fp = pruned_ffn if pruned_ffn is not None else lp["ffn"]
            y, stats = ffn_lib.ffn_forward(
                fp, h, cfg, collect_stats, want_z,
                d_ff=cfg.d_ff if pruned_ffn is None else None)
        elif pruned_ffn is not None:
            y = moe_lib.moe_decode(lp["ffn"], pruned_ffn, h, cfg)
        else:
            y, aux, stats = moe_lib.moe_forward(
                lp["ffn"], h, cfg, collect_stats=collect_stats, want_z=want_z)
        x = x + y
    return x, kv, stats, aux


@torch.no_grad()
def forward(
    params: Dict,
    cfg,
    tokens: Optional[torch.Tensor] = None,
    prefix_emb: Optional[torch.Tensor] = None,
    *,
    collect_stats: bool = False,
    want_kv: bool = False,
    q_chunk: int = 1024,
    logits_mode: str = "all",  # "all" | "last" | "none" (hidden states)
    pruned: Optional[Dict[int, Dict]] = None,
    want_z: bool = False,
) -> Tuple[torch.Tensor, Aux]:
    """Full-sequence forward over ``tokens`` [B, S] (after an optional
    ``prefix_emb`` [B, P, D]: patch or frame embeddings, projected by
    ``params["frontend"]["proj"]`` where the model has a frontend, then
    cast to the model dtype).

    ``logits_mode="last"`` projects only the final position (prefill:
    no [B,S,V] tensor); ``"none"`` returns the final hidden states.
    ``collect_stats`` streams each FF layer's statistics (on the card
    ``s_sq`` is one ``expert_stat`` launch per FF layer); ``want_z``
    adds the activations.  ``pruned``: GRIFFIN-compacted FF blocks
    ``{li: ffn}`` — the *generation-phase* model over a full
    (teacher-forced) sequence, as the paper's evaluation protocol runs
    it.  Serving and evaluation call this entry point, which builds no
    autograd graph; training goes through ``hidden_forward``."""
    return _forward(params, cfg, tokens, prefix_emb, collect_stats=collect_stats,
                    want_kv=want_kv, q_chunk=q_chunk, logits_mode=logits_mode,
                    pruned=pruned, want_z=want_z)


def _forward(
    params: Dict,
    cfg,
    tokens: Optional[torch.Tensor] = None,
    prefix_emb: Optional[torch.Tensor] = None,
    *,
    collect_stats: bool = False,
    want_kv: bool = False,
    q_chunk: int = 1024,
    logits_mode: str = "all",
    pruned: Optional[Dict[int, Dict]] = None,
    want_z: bool = False,
    remat: bool = False,
) -> Tuple[torch.Tensor, Aux]:
    """``forward``'s body, through which autograd passes.  ``remat``
    (training only: no statistics, cache material or pruned FF)
    recomputes each layer in the backward pass from its input
    (``torch.utils.checkpoint``: the reference's ``jax.checkpoint`` with
    ``nothing_saveable``)."""
    if logits_mode not in ("all", "last", "none"):
        raise ValueError(f"logits_mode must be all|last|none, got {logits_mode!r}")
    plan = _mesh_plan(cfg)
    S = sum(t.shape[1] for t in (prefix_emb, tokens) if t is not None)
    sp = plan is not None and shlib.sp_wanted(S)
    with shlib.seq_parallel(sp):
        return _forward_body(params, cfg, tokens, prefix_emb, plan, sp,
                             collect_stats=collect_stats, want_kv=want_kv,
                             q_chunk=q_chunk, logits_mode=logits_mode,
                             pruned=pruned, want_z=want_z, remat=remat)


def _embed(params: Dict, cfg, tokens, prefix_emb, sp: bool) -> torch.Tensor:
    """The input embeddings [B, S, D] (prefix embeddings projected by the
    frontend, then the tokens'); under sequence parallelism this rank's
    block of the sequence: the whole sequence's partial sums (a split
    table's rows; a whole part counted on ``model`` rank 0 only)
    reduce-scattered, or, with no partial part, the whole cut."""
    parts, partial = [], []
    if prefix_emb is not None:
        pe = prefix_emb
        if "frontend" in params:
            w = params["frontend"]["proj"]
            dt = torch.promote_types(pe.dtype, w.dtype)  # as jnp.einsum
            pe = pe.to(dt) @ w.to(dt)
        parts.append(pe.to(param_lib.torch_dtype(cfg.dtype)))
        partial.append(False)
    if tokens is not None:
        parts.append(embed_lookup(params["embed"], tokens.long(), cfg,
                                  summed=not sp))
        partial.append(sp and shlib.model_split(params["embed"]["table"].shape[0],
                                                cfg.vocab_size))
    if sp and any(partial):
        mesh, _ = shlib.active_rules()
        first = float(mesh.coord("model") == 0)
        parts = [p if part else p * first for p, part in zip(parts, partial)]
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return shlib.block_out(x, any(partial)) if sp else x


@contextlib.contextmanager
def _recompute_scope(scope, sp: bool):
    """The mesh scope of a layer's recompute (remat's backward)."""
    with shlib.axis_rules(*scope), shlib.seq_parallel(sp):
        yield


def _forward_body(params, cfg, tokens, prefix_emb, plan, sp: bool, *,
                  collect_stats, want_kv, q_chunk, logits_mode, pruned,
                  want_z, remat):
    params = _gather_top(params, cfg)
    remat_kw = {}
    if plan is not None:
        # the recompute runs in the backward, on the device's autograd
        # thread: it re-enters the mesh scope there
        scope = shlib.active_rules()
        remat_kw["context_fn"] = lambda: (contextlib.nullcontext(),
                                          _recompute_scope(scope, sp))
    x = _embed(params, cfg, tokens, prefix_emb, sp)
    B = x.shape[0]
    S = sum(t.shape[1] for t in (prefix_emb, tokens) if t is not None)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    rope = rope_cos_sin(positions, _rope_width(cfg), cfg.rope_theta)
    kv_list: List[Dict] = []
    stats_tree: Dict[int, Dict] = {}
    moe_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li, desc in enumerate(layer_descs(cfg)):
        gd = None if plan is None else plan["layers"][li]
        if remat:
            x, kv, st, aux = torch.utils.checkpoint.checkpoint(
                _apply_layer, params["layers"][li], desc, x, positions, cfg,
                False, q_chunk, None, False, rope, gd, use_reentrant=False,
                **remat_kw)
        else:
            x, kv, st, aux = _apply_layer(
                params["layers"][li], desc, x, positions, cfg, collect_stats,
                q_chunk, (pruned or {}).get(li), want_z, rope, gd,
            )
        if aux is not None:
            moe_aux = moe_aux + aux
        if want_kv:
            kv_list.append(kv)
        if st is not None:
            stats_tree[li] = st

    x = apply_norm(params["final_norm"], x, cfg)
    if logits_mode == "none":
        out = x  # under sequence parallelism: this rank's block
    elif logits_mode == "last":
        if sp:  # the last position, from the last model rank's block
            x = shlib.seq_replicate(x[:, -1:])
        out = lm_logits(params.get("head", {}), params["embed"], x[:, -1:], cfg)
    else:
        out = lm_logits(params.get("head", {}), params["embed"],
                        shlib.seq_replicate(x) if sp else x, cfg)
    return out, Aux(kv=kv_list if want_kv else None,
                    stats=stats_tree if collect_stats else None,
                    moe_aux=moe_aux)


def hidden_forward(params: Dict, cfg, tokens=None, prefix_emb=None, *,
                   q_chunk: int = 1024, remat: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, Aux]:
    """Final hidden states (pre-head), with autograd: the training
    forward.  ``remat`` defaults to ``cfg.remat``."""
    return _forward(params, cfg, tokens, prefix_emb, q_chunk=q_chunk,
                    logits_mode="none",
                    remat=cfg.remat if remat is None else remat)


# ---------------------------------------------------------------------------
# Loss (chunked cross-entropy: never materializes [B,S,V] fp32 logits)
# ---------------------------------------------------------------------------

def _ce_chunk(x, params, targets, mask, cfg):
    logits = lm_logits(params.get("head", {}), params["embed"], x, cfg)  # fp32
    V = logits.shape[-1]
    if shlib.model_split(V, cfg.vocab_size):
        # this rank's block of the vocabulary: max and sum-exp over
        # ``model``, the gold logit from the rank that owns it
        mesh, _ = shlib.active_rules()
        m = shlib.all_max(logits.amax(dim=-1), "model")
        se = shlib.reduce(torch.exp(logits - m[..., None]).sum(dim=-1), "model")
        lse = m + torch.log(se)
        local = targets.long() - mesh.coord("model") * V
        own = (local >= 0) & (local < V)
        gold = torch.gather(logits, -1, local.clamp(0, V - 1)[..., None])[..., 0]
        gold = shlib.reduce(gold * own, "model")
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = (lse - gold) * mask
    return torch.sum(nll), torch.sum(mask)


def chunked_ce(x: torch.Tensor, params: Dict, targets: torch.Tensor,
               mask: torch.Tensor, cfg, chunk: int = 512,
               over_model: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,D]; targets/mask: [B,S]. Returns (sum nll, count), summed
    chunk by chunk in order (the reference's ``scan``).  On a training
    mesh both are sums over the whole batch: this data rank's sums are
    added over the batch axes (the nll with an identity backward, so each
    rank's gradient is its own rows' share and the train step sums
    them), and with ``over_model`` over ``model`` too (each rank holds a
    block of the sequence)."""
    params = _gather_top(params, cfg)
    nll, cnt = _chunked_ce(x, params, targets, mask, cfg, chunk)
    mesh, rules = shlib.active_rules()
    if mesh is not None:
        axes = shlib.batch_axes(mesh, rules) + (("model",) if over_model else ())
        if axes:
            nll, cnt = shlib.reduce(nll, axes), shlib.all_sum(cnt, axes)
    return nll, cnt


def _chunked_ce(x, params, targets, mask, cfg, chunk):
    B, S, D = x.shape
    if S <= chunk:
        return _ce_chunk(x, params, targets, mask, cfg)
    pad = (-S) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
        S += pad
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        n, k = _ce_chunk(x[:, sl], params, targets[:, sl], mask[:, sl], cfg)
        nll, cnt = nll + n, cnt + k
    return nll, cnt


def _ones(t: torch.Tensor) -> torch.Tensor:
    return torch.ones(t.shape, dtype=torch.float32, device=t.device)


def loss_fn(params: Dict, batch: Dict, cfg) -> Tuple[torch.Tensor, Dict]:
    """batch: {tokens [B,S], (prefix_emb), (targets), (mask)} of tensors.

    For decoder LMs, targets default to next-token shift of ``tokens``;
    encoders require explicit framewise targets.  Returns (loss, metrics)
    with autograd through every parameter the loss reads.  Under sequence
    parallelism (a mesh whose rules split ``seq`` and a length that
    divides) the hidden states are this rank's block of the sequence:
    ``_ce_sp`` forms the cross-entropy's sums and ``_mtp_loss_sp`` the
    MTP term."""
    params = _gather_top(params, cfg)
    prefix = batch.get("prefix_emb")
    tokens = None if cfg.family == "encoder" else batch.get("tokens")
    S = sum(t.shape[1] for t in (prefix, tokens) if t is not None)
    mesh, _ = shlib.active_rules()
    sp = mesh is not None and shlib.sp_wanted(S)
    x, aux = hidden_forward(params, cfg, tokens=tokens, prefix_emb=prefix)
    nll, cnt = (_ce_sp if sp else _ce)(x, params, batch, tokens, cfg)
    ce = nll / torch.clamp_min(cnt, 1.0)
    if cfg.family == "encoder":
        return ce, {"ce": ce}
    loss = ce + cfg.router_aux_coef * aux.moe_aux

    metrics = {"ce": ce, "moe_aux": aux.moe_aux}
    if cfg.mtp_depth and "mtp" in params:
        mtp_loss = (_mtp_loss_sp if sp else _mtp_loss)(params, x, tokens, cfg)
        loss = loss + 0.1 * mtp_loss
        metrics["mtp"] = mtp_loss
    metrics["loss"] = loss
    return loss, metrics


def _ce(x, params: Dict, batch: Dict, tokens, cfg):
    """(sum nll, count) over the text positions of the whole sequence
    (an encoder's: every frame)."""
    targets = batch.get("targets")
    if cfg.family == "encoder":
        return chunked_ce(x, params, targets, batch.get("mask", _ones(targets)), cfg)
    P = 0 if batch.get("prefix_emb") is None else batch["prefix_emb"].shape[1]
    x_text = x[:, P:]
    if targets is None:
        targets = tokens[:, 1:]
        x_text = x_text[:, :-1]
        mask = batch.get("mask", _ones(targets))
        mask = mask[:, : targets.shape[1]]
    else:
        mask = batch.get("mask", _ones(targets))
    return chunked_ce(x_text, params, targets, mask, cfg)


def _full_targets(batch: Dict, tokens, P: int, S: int):
    """Targets and mask [B, S] over every position of the sequence
    (prefix and text), 0 where no target is read: the loss of ``_ce`` as
    one sum over positions."""
    targets = batch.get("targets")
    if targets is not None:
        mask = batch.get("mask", _ones(targets))
        if targets.shape[1] == S:
            return targets, mask
        n = targets.shape[1]
    else:
        n = tokens.shape[1] - 1
        targets = tokens[:, 1:]
        mask = batch.get("mask", _ones(targets))[:, :n]
    B = targets.shape[0]
    t = targets.new_zeros((B, S))
    m = torch.zeros((B, S), dtype=mask.dtype, device=mask.device)
    t[:, P:P + n] = targets
    m[:, P:P + n] = mask
    return t, m


def _ce_sp(x, params: Dict, batch: Dict, tokens, cfg):
    """``_ce`` from this rank's block ``x`` of the sequence.  A vocabulary
    split over ``model`` reads every position (``seq_gather``: the ranks'
    partial gradients summed); a whole one reads this rank's block and
    sums over ``model`` as over the batch axes."""
    prefix = batch.get("prefix_emb")
    P = 0 if prefix is None or tokens is None else prefix.shape[1]
    S = sum(t.shape[1] for t in (prefix, tokens) if t is not None)
    targets, mask = _full_targets(batch, tokens, P, S)
    table = params["head"]["w"] if "head" in params else params["embed"]["table"].T
    with shlib.seq_parallel(True):
        if shlib.model_split(table.shape[-1], cfg.vocab_size):
            return chunked_ce(shlib.seq_gather(x), params, targets, mask, cfg)
        return chunked_ce(x, params, shlib.seq_cut(targets), shlib.seq_cut(mask),
                          cfg, over_model=True)


class _GradScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _mtp_loss_sp(params: Dict, x: torch.Tensor, tokens: torch.Tensor, cfg):
    """The MTP loss under sequence parallelism: the block runs whole on
    every ``model`` rank (its length, S - 2, does not split) from the
    gathered hidden states, whose gradient is the same on every rank
    (``seq_replicate`` keeps this rank's block of it).  The leaves it
    reads that ``model`` does not split get 1/n of their gradient on each
    rank, as the train step sums such leaves over ``model``."""
    specs = _mesh_specs(cfg)
    mesh, _ = shlib.active_rules()
    n = mesh.extent("model")

    def scaled(t, spec):
        if isinstance(t, dict):
            return {k: scaled(v, spec[k]) for k, v in t.items()}
        if isinstance(t, list):
            return [scaled(v, spec[i]) for i, v in enumerate(t)]
        split = any("model" in shlib.dim_axes(spec, d) for d in range(t.dim()))
        return t if split else _GradScale.apply(t, 1.0 / n)

    view = dict(params, **{k: scaled(params[k], specs[k])
                           for k in ("mtp", "embed", "final_norm", "head")
                           if k in params})
    h = shlib.seq_replicate(x)
    with shlib.seq_parallel(False):
        return _mtp_loss(view, h, tokens, cfg)


def _mtp_loss(params: Dict, h: torch.Tensor, tokens: torch.Tensor, cfg
              ) -> torch.Tensor:
    """DeepSeek-V3 multi-token prediction: one extra block predicts t+2."""
    mp = params["mtp"]
    B, S, D = h.shape
    # combine hidden state at t with embedding of token t+1
    h_in = apply_norm(mp["norm_h"], h[:, : S - 2], cfg)
    e_in = apply_norm(mp["norm_e"], embed_lookup(
        params["embed"], tokens[:, 1 : S - 1].long(), cfg), cfg)
    x = torch.cat([h_in, e_in], -1) @ mp["proj"]
    positions = torch.arange(x.shape[1], device=x.device)[None, :].expand(
        x.shape[:2])
    desc = layer_descs(cfg)[-1]
    plan = _mesh_plan(cfg)
    x, _, _, _ = _apply_layer(mp["layer"], desc, x, positions, cfg, False, 1024,
                              gdims=None if plan is None else plan["mtp"]["layer"])
    x = apply_norm(params["final_norm"], x, cfg)
    targets = tokens[:, 2:]
    nll, cnt = chunked_ce(x, params, targets, _ones(targets), cfg)
    return nll / torch.clamp_min(cnt, 1.0)


# ---------------------------------------------------------------------------
# Contiguous decode caches
# ---------------------------------------------------------------------------

def _layer_cache_specs(cfg, desc: LayerDesc, batch: int, max_len: int) -> Dict:
    if desc.mixer == "ssm":
        return ssm_lib.ssm_cache_specs(cfg, batch)
    if desc.mixer == "rec":
        return rglru_lib.rglru_cache_specs(cfg, batch)
    if cfg.use_mla:
        return mla_lib.mla_cache_specs(cfg, batch, max_len)
    return attn_lib.init_cache_specs(cfg, desc.attn_kind, batch, max_len)


def cache_specs(cfg, batch: int, max_len: int) -> List[Dict]:
    """Per-layer decode cache specs (one dict per layer; MLA: the
    compressed ``{ckv, kr}``; SSM / RG-LRU: the fp32 ``state`` / ``h``
    and the conv tail in the model dtype)."""
    return [_layer_cache_specs(cfg, d, batch, max_len) for d in layer_descs(cfg)]


def init_cache(cfg, batch: int, max_len: int, device=None) -> List[Dict]:
    """Zeroed decode caches on ``device`` (default: the card)."""
    dev = backend_lib.resolve_device(device)
    return param_lib.init_params(cache_specs(cfg, batch, max_len), 0,
                                 cfg.dtype, dev)


def kv_specs(cfg, batch: int, seq: int) -> List[Dict]:
    """Per-layer specs of a prefill's cache material (``Aux.kv``) over
    ``seq`` tokens: the decode cache's axes at full length (a window
    layer's K/V are not yet cut to its ring)."""
    out = []
    for d in layer_descs(cfg):
        if d.mixer == "attn" and not cfg.use_mla:
            ax = "window" if (d.attn_kind == "local" and cfg.sliding_window) \
                else "kv_seq"
            out.append({name: ParamSpec(
                (batch, seq, cfg.num_kv_heads, cfg.head_dim),
                ("batch", ax, "kv_heads", "head_dim")) for name in ("k", "v")})
        else:
            out.append(_layer_cache_specs(cfg, d, batch, seq))
    return out


def serve_specs(cfg, spec_tree: List[Dict], mesh, rules) -> List[Dict]:
    """Resolved specs of a per-layer cache (or cache material) tree on a
    serving mesh."""
    return shlib.tree_specs(spec_tree, mesh, rules)


def kv_blocks(cfg, kv: List[Dict], resolved: List[Dict]) -> List[Dict]:
    """A mesh prefill's cache material cut (or gathered) to this rank's
    blocks of ``resolved`` (``serve_specs`` of ``kv_specs``).  The rank
    holds its batch rows, every position, the KV heads its key / value
    projections hold (their resolved ``kv_heads`` / ``head_dim`` axes),
    an SSM layer's heads (``a_log``'s axes) with the whole conv tail, and
    an RG-LRU layer's block of the width (``w_x``'s); the latent material
    has no model split."""
    specs = _mesh_specs(cfg)
    out = []
    for li, (d, layer_kv, rs) in enumerate(zip(layer_descs(cfg), kv, resolved)):
        held: Dict[str, Tuple] = {}
        ws = specs["layers"][li]["mixer"]
        if d.mixer == "attn" and not cfg.use_mla:
            for name, w in (("k", "wk"), ("v", "wv")):
                held[name] = ((), (), shlib.dim_axes(ws[w], 1),
                              shlib.dim_axes(ws[w], 2))
        elif d.mixer == "ssm":
            held["state"] = ((), shlib.dim_axes(ws["a_log"], 0), (), ())
        elif d.mixer == "rec":
            lru = shlib.dim_axes(ws["w_x"], 1)
            held = {"h": ((), lru), "conv": ((), (), lru)}
        blocks = {}
        for name, t in layer_kv.items():
            have = held.get(name, ((),) * t.dim())
            blocks[name] = shlib.relayout(t, {
                dim: (have[dim], shlib.dim_axes(rs[name], dim))
                for dim in range(1, t.dim())})
        out.append(blocks)
    return out


def fill_cache_from_prefill(cfg, cache: List[Dict], kv: List[Dict]) -> List[Dict]:
    """Scatter prefill K/V (``Aux.kv``) into the decode caches, and copy
    recurrent states and conv tails across (cast to the cache's dtype),
    all in place."""
    for desc, c, layer_kv in zip(layer_descs(cfg), cache, kv):
        if desc.mixer != "attn":
            for name, buf in c.items():
                buf.copy_(layer_kv[name])
        elif cfg.use_mla:
            mla_lib.mla_fill_cache(c, layer_kv["ckv"], layer_kv["kr"])
        else:
            attn_lib.fill_cache(c, layer_kv["k"], layer_kv["v"])
    return cache


def recurrent_state(cfg, cache: List[Dict]) -> Dict[int, Dict]:
    """Copies of every layer's recurrent cache leaves (SSM ``state`` /
    RG-LRU ``h`` and their conv tails), ``{li: {name: tensor}}``.  A
    decode step advances them in place, so a caller that runs two steps
    from one cache at one ``pos`` saves them first and puts them back
    with ``restore_recurrent_state`` (KV slots need no such care: each
    step rewrites slot ``pos`` before reading it)."""
    return {li: {k: v.clone() for k, v in cache[li].items()}
            for li, d in enumerate(layer_descs(cfg)) if d.mixer != "attn"}


def restore_recurrent_state(cache: List[Dict], saved: Dict[int, Dict]) -> None:
    """Write ``recurrent_state``'s copies back into ``cache``, in place."""
    for li, leaves in saved.items():
        for k, v in leaves.items():
            cache[li][k].copy_(v)


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------

def _gather_pruned(pf: Optional[Dict], cfg) -> Optional[Dict]:
    """A compacted FF block with its FSDP (``embed`` over ``data``) split
    gathered (as it is off a mesh)."""
    if pf is None or pf["w1"].shape[0] == cfg.d_model:
        return pf
    names = [k for k in ("w1", "wg", "w2") if k in pf]
    full = shlib.gather([pf[k] for k in names],
                        [1 if k == "w2" else 0 for k in names], "data")
    return dict(pf, **dict(zip(names, full)))


def _apply_layer_decode(lp: Dict, desc: LayerDesc, cache: Dict,
                        x: torch.Tensor, pos: int, cfg,
                        pruned_ffn: Optional[Dict], rope=None, gdims=None,
                        wspec: Optional[Dict] = None,
                        cspec: Optional[Dict] = None):
    lp = _gather(lp, gdims)  # FSDP: this layer's weights, inside the layer
    pruned_ffn = _gather_pruned(pruned_ffn, cfg)
    h = apply_norm(lp["mixer_norm"], x, cfg)
    if desc.mixer == "ssm":
        y, cache = ssm_lib.ssm_decode(lp["mixer"], cache, h, cfg)
    elif desc.mixer == "rec":
        y, cache = rglru_lib.rglru_decode(lp["mixer"], cache, h, cfg)
    elif cfg.use_mla:
        y, cache = mla_lib.mla_decode(lp["mixer"], cache, h, pos, cfg,
                                      rope=rope, wspec=wspec, cspec=cspec)
    else:
        y, cache = attn_lib.attn_decode(lp["mixer"], cache, h, pos, cfg,
                                        kind=desc.attn_kind, rope=rope,
                                        wspec=wspec, cspec=cspec)
    x = x + y
    if desc.ffn != "none":
        h = apply_norm(lp["ffn_norm"], x, cfg)
        if desc.ffn == "dense":
            # a split hidden (mlp over model) reduces its down-projection
            fp, F = (lp["ffn"], cfg.d_ff) if pruned_ffn is None else \
                (pruned_ffn, ffn_lib.mesh_width(pruned_ffn["w1"].shape[-1]))
            y, _ = ffn_lib.ffn_forward(fp, h, cfg, d_ff=F)
        else:
            y = moe_lib.moe_decode(lp["ffn"], pruned_ffn, h, cfg)
        x = x + y
    return x, cache


@torch.no_grad()
def decode_step(
    params: Dict,
    cfg,
    cache: List[Dict],
    token: torch.Tensor,
    pos: int,
    pruned: Optional[Dict[int, Dict]] = None,
    cache_specs: Optional[List[Dict]] = None,
) -> Tuple[torch.Tensor, List[Dict]]:
    """One generation step.  token: [B,1] int; ``pos``: tokens so far, a
    host int shared by the batch.

    ``pruned``: optional GRIFFIN-compacted FF blocks ``{li: ffn}``
    (``extract_ffn_tree`` / ``griffin.compact_tree``); when given, the
    dense FF blocks (and MoE shared experts) use the expert neurons
    only — the paper's generation phase.  The caches are written **in
    place** (the reference's are functional): see ``attention.attn_decode`` for the order that keeps
    two steps from one cache at one ``pos`` equal to the reference's; a
    recurrent layer's state moves on at every step, so such a caller
    restores it in between (``recurrent_state``).
    Returns (logits [B,1,V] fp32, cache).

    On a serving mesh (``sharding.axis_rules``, more than one rank) this
    is one rank's shard: ``params``, ``cache`` and ``pruned`` hold its
    blocks, ``cache_specs`` the cache's resolved specs (``serve_specs``),
    and the logits are this rank's block of the vocabulary.  Each layer
    gathers its FSDP leaves, attention places its collectives by the
    resolved specs of its weights and cache block, the FF blocks reduce
    their split down-projections, MoE layers take the training forward's
    expert-parallel paths, and the SSM / RG-LRU mixers run on their
    heads' or width's block (their caches hold that block).  Off a mesh
    every one of these is the identity."""
    pos = int(pos)
    mesh, _ = shlib.active_rules()
    if mesh is not None and mesh.size > 1 and cache_specs is None:
        raise ValueError("decode_step on a serving mesh needs the "
                         "cache's resolved specs (serve_specs)")
    plan, specs = _mesh_plan(cfg), _mesh_specs(cfg)
    params = _gather_top(params, cfg)
    x = embed_lookup(params["embed"], token.long(), cfg)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    rope = rope_cos_sin(positions, _rope_width(cfg), cfg.rope_theta)
    for li, desc in enumerate(layer_descs(cfg)):
        x, _ = _apply_layer_decode(
            params["layers"][li], desc, cache[li], x, pos, cfg,
            (pruned or {}).get(li), rope,
            gdims=plan and plan["layers"][li],
            wspec=specs and specs["layers"][li]["mixer"],
            cspec=cache_specs and cache_specs[li])
    x = apply_norm(params["final_norm"], x, cfg)
    logits = lm_logits(params.get("head", {}), params["embed"], x, cfg)
    return logits, cache


# ---------------------------------------------------------------------------
# Paged-KV serving path (block-table pools; see serving/paged.py)
# ---------------------------------------------------------------------------

def supports_paged(cfg) -> bool:
    """The paged path covers the GQA/MQA attention families (dense FF or
    no FF) without a frontend, with fp caches: the reference's own
    predicate.  MLA / MoE, SSM, RG-LRU and the encoder and VLM frontends
    take the contiguous caches and the ``ContinuousBatcher``; an int8
    contiguous cache has no paged form (the paged pools quantize through
    ``kv_dtype``)."""
    return (
        all(d.mixer == "attn" for d in layer_descs(cfg))
        and not cfg.use_mla
        and not cfg.num_experts
        and not getattr(cfg, "kv_cache_int8", False)
        and not cfg.frontend
    )


def paged_pool_specs(cfg, num_pages: int, page_size: int,
                     kv_dtype: str = "fp32") -> List[Dict]:
    """Per-layer KV page pools (one dict per layer)."""
    assert supports_paged(cfg), cfg.name
    return [attn_lib.paged_cache_specs(cfg, num_pages, page_size, kv_dtype)
            for _ in range(cfg.num_layers)]


def init_paged_pools(cfg, num_pages: int, page_size: int,
                     kv_dtype: str = "fp32", device=None) -> List[Dict]:
    """Zeroed pools on ``device`` (default: the card)."""
    dev = backend_lib.resolve_device(device)
    return param_lib.init_params(
        paged_pool_specs(cfg, num_pages, page_size, kv_dtype), 0, cfg.dtype,
        dev,
    )


def copy_pool_pages(cfg, pools: List[Dict], src: torch.Tensor,
                    dst: torch.Tensor) -> List[Dict]:
    """Copy whole KV pages ``src[i] -> dst[i]`` in every layer pool,
    **in place** (the device half of copy-on-write; ``dst`` pages are
    always fresh, so no pair reads another's destination)."""
    src = src.long()
    dst = dst.long()
    for pool in pools:
        for buf in pool.values():  # data pages and, quantized, their scales
            b = kv_quant.as_bytes(buf)
            b[dst] = b[src]
    return pools


def _apply_layer_paged(
    lp: Dict,
    desc: LayerDesc,
    pool: Dict,
    x: torch.Tensor,
    block_tables: torch.Tensor,
    pos: torch.Tensor,
    write_mask: torch.Tensor,
    cfg,
    pruned_ffn: Optional[Dict],
    collect_stats: bool,
    backend: str = "gather",
    kv_dtype: str = "fp32",
    positions: Optional[torch.Tensor] = None,
    rope=None,
):
    h = apply_norm(lp["mixer_norm"], x, cfg)
    y, pool = attn_lib.paged_attn_step(
        lp["mixer"], pool, block_tables, h, pos, write_mask, cfg,
        kind=desc.attn_kind, backend=backend, kv_dtype=kv_dtype,
        positions=positions, rope=rope,
    )
    x = x + y

    stats = None
    if desc.ffn == "dense":
        h = apply_norm(lp["ffn_norm"], x, cfg)
        if pruned_ffn is not None:
            y = ffn_lib.ffn_forward_perslot(pruned_ffn, h, cfg)
        else:
            z = ffn_lib.ffn_activations(lp["ffn"], h, cfg)
            if collect_stats:
                # padded chunk tokens must not pollute the statistics:
                # zeroed rows contribute exactly 0 to every reduction.
                # Under tensor parallelism x_sq is replicated, s_sq and
                # z_sq hold this rank's F-block (tp.gather_stats)
                m = write_mask[:, :, None]
                zm = z * m.to(z.dtype)
                hm = (h * m.to(h.dtype)).float()
                stats = {
                    "s_sq": ffn_lib.griffin_stat_sq(zm),
                    "x_sq": hm.square().sum(dim=(0, 1)),
                    "z_sq": zm.float().square().sum(dim=(0, 1)),
                }
            y = psum_if_tp(z @ lp["ffn"]["w2"])
            if "b2" in lp["ffn"]:
                y = y + lp["ffn"]["b2"]
        x = x + y
    return x, stats


@torch.no_grad()
def decode_step_paged(
    params: Dict,
    cfg,
    pools: List[Dict],
    block_tables: torch.Tensor,  # [B, n_pages] int32, -1 = unallocated
    token: torch.Tensor,  # [B, S] int (decode: S=1; prefill chunk: S=chunk)
    pos: torch.Tensor,  # [B] int32 tokens already cached per request
    write_mask: Optional[torch.Tensor] = None,  # [B, S] bool
    pruned: Optional[Dict[int, Dict]] = None,  # per-slot compacted FF, by layer
    collect_stats: bool = False,
    backend: str = "gather",
    kv_dtype: str = "fp32",
) -> Tuple[torch.Tensor, List[Dict], Optional[Dict[int, Dict]]]:
    """Batched paged step with per-request positions.

    Unifies chunked prefill (B=1, S=chunk, ``collect_stats`` streams the
    GRIFFIN ``s_sq`` statistic per chunk) and batched decode (S=1, one
    request per slot, ``pruned`` holds per-slot compacted FF weights).
    ``backend`` picks the attention path (``attention.resolve_attn_backend``).
    The pools are updated **in place** and returned.
    Returns (logits [B,S,V] fp32, pools, {li: stats} or None)."""
    B, S = token.shape
    if write_mask is None:
        write_mask = torch.ones((B, S), dtype=torch.bool, device=token.device)
    x = embed_lookup(params["embed"], token.long(), cfg)
    # token positions and their RoPE angles are the same in every layer
    positions = pos.long()[:, None] + torch.arange(S, device=token.device)[None, :]
    rope = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    stats_tree: Dict[int, Dict] = {}
    for li, desc in enumerate(layer_descs(cfg)):
        pf = (pruned or {}).get(li)
        x, st = _apply_layer_paged(
            params["layers"][li], desc, pools[li], x, block_tables, pos,
            write_mask, cfg, pf, collect_stats, backend, kv_dtype,
            positions, rope,
        )
        if st is not None:
            stats_tree[li] = st
    x = apply_norm(params["final_norm"], x, cfg)
    logits = lm_logits(params.get("head", {}), params["embed"], x, cfg)
    return logits, pools, (stats_tree if collect_stats else None)


@torch.no_grad()
def draft_loop_paged(
    params: Dict,
    cfg,
    pools: List[Dict],
    block_tables: torch.Tensor,  # [B, n_pages] int32, -1 = unallocated
    token: torch.Tensor,  # [B, 1] int32: last committed token per slot
    pos: torch.Tensor,  # [B] int32 committed KV length per slot
    k_r: torch.Tensor,  # [B] int32 per-slot draft lengths (<= num_steps)
    pruned: Optional[Dict[int, Dict]] = None,  # per-slot compacted FF (the draft)
    *,
    num_steps: int,
    backend: str = "gather",
    kv_dtype: str = "fp32",
) -> Tuple[torch.Tensor, List[Dict]]:
    """``num_steps`` greedy draft iterations of the ``[B, 1]`` paged
    decode step, with no host sync: argmax feedback, draft-KV page writes
    and the per-slot GRIFFIN-compacted FF weights stay on the device (the
    reference's ``lax.scan`` is a Python loop here).

    Slot ``b`` takes part in iteration ``i`` only while ``i < k_r[b]``: a
    masked slot's KV write is suppressed (``write_mask`` row False) and
    its token is frozen, so its drafts past ``k_r[b]`` are garbage that
    nothing consumes.  ``torch.argmax`` takes the first maximum, as
    ``jnp.argmax`` and ``np.argmax`` do, so the drafts equal the
    per-token host loop's.

    Returns (draft tokens [B, num_steps] int32, pools updated in place)."""
    tok = token
    drafts = []
    for i in range(num_steps):
        live = k_r > i  # [B] bool
        logits, pools, _ = decode_step_paged(
            params, cfg, pools, block_tables, tok, pos + i,
            write_mask=live[:, None], pruned=pruned, backend=backend,
            kv_dtype=kv_dtype,
        )
        nxt = torch.argmax(logits[:, 0, :], dim=-1).to(token.dtype)
        tok = torch.where(live[:, None], nxt[:, None], tok)
        drafts.append(nxt)
    if not drafts:
        return token.new_zeros((token.shape[0], 0)), pools
    return torch.stack(drafts, dim=1), pools


@torch.no_grad()
def verify_step_paged(
    params: Dict,
    cfg,
    pools: List[Dict],
    block_tables: torch.Tensor,  # [B, n_pages] int32, -1 = unallocated
    tokens: torch.Tensor,  # [B, k+1] int32: last committed token + k drafts
    pos: torch.Tensor,  # [B] int32 committed KV length per request
    write_mask: torch.Tensor,  # [B, k+1] bool
    backend: str = "gather",
    kv_dtype: str = "fp32",
) -> Tuple[torch.Tensor, List[Dict]]:
    """Dense multi-token verify step of self-speculative decoding: all
    ``k+1`` positions of a drafted continuation scored in one batched
    pass with the full weights.  Token ``tokens[b, i]`` sits at position
    ``pos[b] + i``; its dense KV overwrites what the draft wrote there,
    so accepted positions hold exactly the KV a dense decode would have
    written (rejected ones sit past ``cache_len`` after the commit,
    where every reader masks them).  Its attention launches count as
    verify calls (``paged_attn.counting_as``).

    Returns (logits [B, k+1, V]: row ``i`` scores the position after
    input ``i``, pools updated in place)."""
    with paged_attn_lib.counting_as("verify"):
        logits, pools, _ = decode_step_paged(
            params, cfg, pools, block_tables, tokens, pos,
            write_mask=write_mask, pruned=None, backend=backend,
            kv_dtype=kv_dtype,
        )
    return logits, pools


@torch.no_grad()
def draft_verify_paged(
    params: Dict,
    cfg,
    pools: List[Dict],
    block_tables: torch.Tensor,  # [B, n_pages] int32, -1 = unallocated
    token: torch.Tensor,  # [B, 1] int32: last committed token per slot
    pos: torch.Tensor,  # [B] int32 committed KV length per slot
    k_r: torch.Tensor,  # [B] int32 per-slot draft lengths (0 = no drafting)
    row_live: torch.Tensor,  # [B] bool: slot holds a planned request
    pruned: Optional[Dict[int, Dict]] = None,  # per-slot compacted FF (the draft)
    *,
    num_steps: int,
    spec_k: int,
    backend: str = "gather",
    kv_dtype: str = "fp32",
) -> Tuple[torch.Tensor, torch.Tensor, List[Dict]]:
    """A whole speculative round, draft loop and dense verify, with no
    host sync: the drafts feed the ``[B, spec_k+1]`` verify matrix on the
    device (last committed token in column 0, each slot's drafts after
    it, zeros after those), rows masked to ``row_live & (i <= k_r)``.  An
    empty slot's verify row is masked whole; a live slot that drafted 0
    tokens verifies just its last token, a dense decode step.
    ``num_steps`` may exceed ``spec_k``: the surplus draft columns are
    dropped (every ``k_r`` is at most both).

    Returns (drafts [B, num_steps], verify logits [B, spec_k+1, V],
    pools updated in place)."""
    drafts, pools = draft_loop_paged(
        params, cfg, pools, block_tables, token, pos, k_r, pruned,
        num_steps=num_steps, backend=backend, kv_dtype=kv_dtype,
    )
    B = token.shape[0]
    cols = min(num_steps, spec_k)
    vtoks = torch.cat([token, drafts[:, :cols],
                       token.new_zeros((B, spec_k - cols))], dim=1)
    idx = torch.arange(spec_k + 1, device=token.device)[None, :]
    vmask = row_live[:, None] & (idx <= k_r[:, None])
    vlogits, pools = verify_step_paged(
        params, cfg, pools, block_tables, vtoks, pos, vmask,
        backend=backend, kv_dtype=kv_dtype,
    )
    return drafts, vlogits, pools


# ---------------------------------------------------------------------------
# GRIFFIN plumbing
# ---------------------------------------------------------------------------

def _prunable(cfg, desc: LayerDesc) -> bool:
    """A GRIFFIN-prunable FF block: dense, or MoE with shared experts."""
    return desc.ffn == "dense" or (desc.ffn == "moe"
                                   and bool(cfg.num_shared_experts))


def extract_ffn_tree(params: Dict, cfg) -> Dict[int, Dict]:
    """``{li: ffn params}`` of every GRIFFIN-prunable FF block (dense FF
    or MoE shared experts), mirroring the stats tree of
    ``forward(collect_stats=True)``."""
    out: Dict[int, Dict] = {}
    for li, d in enumerate(layer_descs(cfg)):
        if _prunable(cfg, d):
            ffn = params["layers"][li]["ffn"]
            out[li] = ffn["shared"] if d.ffn == "moe" else ffn
    return out


def pruned_ffn_specs(cfg, sparsity: Optional[float] = None, *, gcfg=None,
                     tier: Optional[float] = None, profile=None
                     ) -> Dict[int, Dict]:
    """ParamSpec tree ``{li: ffn specs}`` of the GRIFFIN-compacted decode
    FF blocks (the dry-run's abstract inputs), mirroring
    ``extract_ffn_tree``.  Budgets come from ``griffin.plan_k_tree``:
    pass a ``gcfg`` (and optionally ``tier`` / ``profile``) for per-layer
    widths, or the scalar ``sparsity`` (``keep = 1 - sparsity``).  Each
    layer keeps its own width (the reference stacks the instances of a
    scan leaf at the widest)."""
    from repro_torch.core import griffin as griffin_lib

    if gcfg is None:
        if sparsity is None:
            raise ValueError("pruned_ffn_specs: pass sparsity or gcfg")
        gcfg = griffin_lib.GriffinConfig(sparsity=sparsity)
    ks = griffin_lib.plan_k_tree(cfg, gcfg, tier=tier, profile=profile)
    return {li: ffn_lib.ffn_specs(cfg, d_ff=k) for li, k in ks.items()}


def prune_stats_tree(stats: Dict[int, Dict], cfg) -> Dict[int, Dict]:
    """Keep the stats of layers with a GRIFFIN-prunable FF block."""
    descs = layer_descs(cfg)
    return {li: st for li, st in stats.items() if _prunable(cfg, descs[li])}
