"""Model assembly for the attention families, dense, MoE and MLA (port
of ``repro/models/decoder.py``: the contiguous prefill/decode path and
the paged serving path, which covers the dense GQA families only).

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
    forward(params, cfg, tokens, ...)        -> logits, Aux
    hidden_forward(params, cfg, tokens, ...) -> hidden states, Aux
    cache_specs(cfg, batch, max_len)         -> ParamSpec list (decode cache)
    init_cache(cfg, batch, max_len, device)  -> cache
    fill_cache_from_prefill(cfg, cache, kv)  -> cache
    decode_step(params, cfg, cache, token, pos, pruned=None) -> logits, cache
    init_paged_pools(cfg, num_pages, page_size, kv_dtype, device) -> pools
    copy_pool_pages(cfg, pools, src, dst)    -> pools (COW page forks)
    decode_step_paged(params, cfg, pools, bt, tokens, pos, ...) -> logits, pools, stats
    draft_loop_paged(params, cfg, pools, bt, token, pos, k_r, ...) -> drafts, pools
    verify_step_paged(params, cfg, pools, bt, tokens, pos, mask, ...) -> logits, pools
    draft_verify_paged(params, cfg, pools, bt, token, pos, k_r, live, ...)
                                             -> drafts, logits, pools
    extract_ffn_tree(params, cfg)            -> {li: dense-FF / MoE shared params}
    prune_stats_tree(stats, cfg)             -> {li: stats}
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

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

def layer_specs(cfg, desc: LayerDesc) -> Dict:
    s: Dict[str, Any] = {
        "mixer_norm": norm_specs(cfg),
        "mixer": mla_lib.mla_specs(cfg) if cfg.use_mla else attn_lib.attn_specs(cfg),
    }
    if desc.ffn == "dense":
        s["ffn_norm"] = norm_specs(cfg)
        s["ffn"] = ffn_lib.ffn_specs(cfg)
    elif desc.ffn == "moe":
        s["ffn_norm"] = norm_specs(cfg)
        s["ffn"] = moe_lib.moe_specs(cfg)
    return s


def model_specs(cfg) -> Dict:
    assert supports_contiguous(cfg), \
        f"{cfg.name}: the port covers attention families"
    specs: Dict[str, Any] = {"embed": embed_specs(cfg)}
    hs = head_specs(cfg)
    if hs:
        specs["head"] = hs
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


def init_params(cfg, seed: int = 0, device=None) -> Dict:
    """Random parameters from ``seed`` on ``device`` (default: the card;
    raises without one unless ``device="cpu"``)."""
    dev = backend_lib.resolve_device(device)
    return param_lib.init_params(model_specs(cfg), seed, cfg.dtype, dev)


# ---------------------------------------------------------------------------
# Aux container
# ---------------------------------------------------------------------------

@dataclass
class Aux:
    """Per-forward side outputs, per layer: ``kv`` a list of ``{k, v}``
    (MLA: ``{ckv, kr}``, prefill cache material), ``stats`` ``{li: {s_sq
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

def supports_contiguous(cfg) -> bool:
    """The contiguous path covers the attention families: GQA/MQA or MLA
    mixers, dense, MoE or no FF, with an fp or int8 decode cache (SSM,
    RG-LRU and frontend families are not ported)."""
    return all(d.mixer == "attn" for d in layer_descs(cfg)) and not cfg.frontend


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
):
    h = apply_norm(lp["mixer_norm"], x, cfg)
    if cfg.use_mla:
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
        h = apply_norm(lp["ffn_norm"], x, cfg)
        if desc.ffn == "dense":
            fp = pruned_ffn if pruned_ffn is not None else lp["ffn"]
            y, stats = ffn_lib.ffn_forward(fp, h, cfg, collect_stats, want_z)
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
    ``prefix_emb`` [B, P, D]).

    ``logits_mode="last"`` projects only the final position (prefill:
    no [B,S,V] tensor); ``"none"`` returns the final hidden states.
    ``collect_stats`` streams each FF layer's statistics (on the card
    ``s_sq`` is one ``expert_stat`` launch per FF layer); ``want_z``
    adds the activations.  ``pruned``: GRIFFIN-compacted FF blocks
    ``{li: ffn}`` — the *generation-phase* model over a full
    (teacher-forced) sequence, as the paper's evaluation protocol runs
    it.  The reference's ``remat`` is a training option (not ported)."""
    if logits_mode not in ("all", "last", "none"):
        raise ValueError(f"logits_mode must be all|last|none, got {logits_mode!r}")
    parts = []
    if prefix_emb is not None:
        parts.append(prefix_emb.to(param_lib.torch_dtype(cfg.dtype)))
    if tokens is not None:
        parts.append(embed_lookup(params["embed"], tokens.long(), cfg))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    rope = rope_cos_sin(positions, _rope_width(cfg), cfg.rope_theta)
    kv_list: List[Dict] = []
    stats_tree: Dict[int, Dict] = {}
    moe_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li, desc in enumerate(layer_descs(cfg)):
        x, kv, st, aux = _apply_layer(
            params["layers"][li], desc, x, positions, cfg, collect_stats,
            q_chunk, (pruned or {}).get(li), want_z, rope,
        )
        if aux is not None:
            moe_aux = moe_aux + aux
        if want_kv:
            kv_list.append(kv)
        if st is not None:
            stats_tree[li] = st

    x = apply_norm(params["final_norm"], x, cfg)
    if logits_mode == "none":
        out = x
    elif logits_mode == "last":
        out = lm_logits(params.get("head", {}), params["embed"], x[:, -1:], cfg)
    else:
        out = lm_logits(params.get("head", {}), params["embed"], x, cfg)
    return out, Aux(kv=kv_list if want_kv else None,
                    stats=stats_tree if collect_stats else None,
                    moe_aux=moe_aux)


def hidden_forward(params: Dict, cfg, tokens=None, prefix_emb=None, *,
                   q_chunk: int = 1024) -> Tuple[torch.Tensor, Aux]:
    """Final hidden states (pre-head)."""
    return forward(params, cfg, tokens, prefix_emb, q_chunk=q_chunk,
                   logits_mode="none")


# ---------------------------------------------------------------------------
# Contiguous decode caches
# ---------------------------------------------------------------------------

def cache_specs(cfg, batch: int, max_len: int) -> List[Dict]:
    """Per-layer decode cache specs (one dict per layer; MLA: the
    compressed ``{ckv, kr}``)."""
    assert supports_contiguous(cfg), cfg.name
    if cfg.use_mla:
        return [mla_lib.mla_cache_specs(cfg, batch, max_len)
                for _ in range(cfg.num_layers)]
    return [attn_lib.init_cache_specs(cfg, d.attn_kind, batch, max_len)
            for d in layer_descs(cfg)]


def init_cache(cfg, batch: int, max_len: int, device=None) -> List[Dict]:
    """Zeroed decode caches on ``device`` (default: the card)."""
    dev = backend_lib.resolve_device(device)
    return param_lib.init_params(cache_specs(cfg, batch, max_len), 0,
                                 cfg.dtype, dev)


def fill_cache_from_prefill(cfg, cache: List[Dict], kv: List[Dict]) -> List[Dict]:
    """Scatter prefill K/V (``Aux.kv``) into the decode caches, in place."""
    for c, layer_kv in zip(cache, kv):
        if cfg.use_mla:
            mla_lib.mla_fill_cache(c, layer_kv["ckv"], layer_kv["kr"])
        else:
            attn_lib.fill_cache(c, layer_kv["k"], layer_kv["v"])
    return cache


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------

def _apply_layer_decode(lp: Dict, desc: LayerDesc, cache: Dict,
                        x: torch.Tensor, pos: int, cfg,
                        pruned_ffn: Optional[Dict], rope=None):
    h = apply_norm(lp["mixer_norm"], x, cfg)
    if cfg.use_mla:
        y, cache = mla_lib.mla_decode(lp["mixer"], cache, h, pos, cfg, rope=rope)
    else:
        y, cache = attn_lib.attn_decode(lp["mixer"], cache, h, pos, cfg,
                                        kind=desc.attn_kind, rope=rope)
    x = x + y
    if desc.ffn != "none":
        h = apply_norm(lp["ffn_norm"], x, cfg)
        if desc.ffn == "dense":
            fp = pruned_ffn if pruned_ffn is not None else lp["ffn"]
            y, _ = ffn_lib.ffn_forward(fp, h, cfg)
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
) -> Tuple[torch.Tensor, List[Dict]]:
    """One generation step.  token: [B,1] int; ``pos``: tokens so far, a
    host int shared by the batch.

    ``pruned``: optional GRIFFIN-compacted FF blocks ``{li: ffn}``
    (``extract_ffn_tree`` / ``griffin.compact_tree``); when given, the
    dense FF blocks (and MoE shared experts) use the expert neurons
    only — the paper's generation phase.  The caches are written **in
    place** (the reference's are functional): see ``attention.attn_decode`` for the order that keeps
    two steps from one cache at one ``pos`` equal to the reference's.
    Returns (logits [B,1,V] fp32, cache)."""
    pos = int(pos)
    x = embed_lookup(params["embed"], token.long(), cfg)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    rope = rope_cos_sin(positions, _rope_width(cfg), cfg.rope_theta)
    for li, desc in enumerate(layer_descs(cfg)):
        x, _ = _apply_layer_decode(params["layers"][li], desc, cache[li], x,
                                   pos, cfg, (pruned or {}).get(li), rope)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = lm_logits(params.get("head", {}), params["embed"], x, cfg)
    return logits, cache


# ---------------------------------------------------------------------------
# Paged-KV serving path (block-table pools; see serving/paged.py)
# ---------------------------------------------------------------------------

def supports_paged(cfg) -> bool:
    """The paged path covers the GQA/MQA attention families (dense FF or
    no FF) with fp caches: the reference's own predicate.  MLA / MoE
    (and the unported SSM / RG-LRU / frontend families) take the
    contiguous caches and the ``ContinuousBatcher``; an int8 contiguous
    cache has no paged form (the paged pools quantize through
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
                # zeroed rows contribute exactly 0 to every reduction
                m = write_mask[:, :, None]
                zm = z * m.to(z.dtype)
                hm = (h * m.to(h.dtype)).float()
                stats = {
                    "s_sq": ffn_lib.griffin_stat_sq(zm),
                    "x_sq": hm.square().sum(dim=(0, 1)),
                    "z_sq": zm.float().square().sum(dim=(0, 1)),
                }
            y = z @ lp["ffn"]["w2"]
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


def prune_stats_tree(stats: Dict[int, Dict], cfg) -> Dict[int, Dict]:
    """Keep the stats of layers with a GRIFFIN-prunable FF block."""
    descs = layer_descs(cfg)
    return {li: st for li, st in stats.items() if _prunable(cfg, descs[li])}
