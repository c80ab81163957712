"""Model assembly for the paged serving path (port of the paged subset of
``repro/models/decoder.py``).

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
    init_paged_pools(cfg, num_pages, page_size, kv_dtype, device) -> pools
    copy_pool_pages(cfg, pools, src, dst)    -> pools (COW page forks)
    decode_step_paged(params, cfg, pools, bt, tokens, pos, ...) -> logits, pools, stats
    extract_ffn_tree(params, cfg)            -> {li: dense-FF params}
    prune_stats_tree(stats, cfg)             -> {li: stats}
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import backend as backend_lib
from repro_torch.kernels import kv_quant
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
        "mixer": attn_lib.attn_specs(cfg),
    }
    if desc.ffn == "dense":
        s["ffn_norm"] = norm_specs(cfg)
        s["ffn"] = ffn_lib.ffn_specs(cfg)
    return s


def model_specs(cfg) -> Dict:
    assert supports_paged(cfg), f"{cfg.name}: the port covers attention families"
    specs: Dict[str, Any] = {"embed": embed_specs(cfg)}
    hs = head_specs(cfg)
    if hs:
        specs["head"] = hs
    specs["layers"] = [layer_specs(cfg, d) for d in layer_descs(cfg)]
    specs["final_norm"] = norm_specs(cfg)
    return specs


def init_params(cfg, seed: int = 0, device=None) -> Dict:
    """Random parameters from ``seed`` on ``device`` (default: the card;
    raises without one unless ``device="cpu"``)."""
    dev = backend_lib.resolve_device(device)
    return param_lib.init_params(model_specs(cfg), seed, cfg.dtype, dev)


# ---------------------------------------------------------------------------
# Paged-KV serving path (block-table pools; see serving/paged.py)
# ---------------------------------------------------------------------------

def supports_paged(cfg) -> bool:
    """The paged path covers the GQA/MQA attention families (dense FF or
    no FF)."""
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


# ---------------------------------------------------------------------------
# GRIFFIN plumbing
# ---------------------------------------------------------------------------

def extract_ffn_tree(params: Dict, cfg) -> Dict[int, Dict]:
    """``{li: ffn params}`` of every GRIFFIN-prunable (dense) FF block,
    mirroring the stats tree of ``decode_step_paged(collect_stats=True)``."""
    return {li: params["layers"][li]["ffn"]
            for li, d in enumerate(layer_descs(cfg)) if d.ffn == "dense"}


def prune_stats_tree(stats: Dict[int, Dict], cfg) -> Dict[int, Dict]:
    """Keep the stats of layers with a dense FF block."""
    descs = layer_descs(cfg)
    return {li: st for li, st in stats.items() if descs[li].ffn == "dense"}
