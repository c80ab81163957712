"""GQA/MQA attention on paged KV caches (port of the paged half of
``repro/models/layers/attention.py``).

The pool of one attention layer holds ``num_pages + 1`` fixed-size pages
shared by all live requests; the extra final page is a write-off
("trash") target for padded tokens on the gather path.  A request's
logical KV positions map to pool pages through its block table (page
ids, -1 = unallocated).  All softmax math runs in fp32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import kv_quant, ops, ref
from repro_torch.models.common import apply_rope, rms_normalize
from repro_torch.models.param import ParamSpec

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def attn_specs(cfg) -> Dict[str, ParamSpec]:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((D, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((D, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((D, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, hd, D), ("heads", "head_dim", "embed")),
    }
    if cfg.use_bias:
        specs["bq"] = ParamSpec((H, hd), ("heads", "head_dim"), init="zeros")
        specs["bk"] = ParamSpec((KV, hd), ("kv_heads", "head_dim"), init="zeros")
        specs["bv"] = ParamSpec((KV, hd), ("kv_heads", "head_dim"), init="zeros")
        specs["bo"] = ParamSpec((D,), ("act_embed",), init="zeros")
    if getattr(cfg, "qk_norm", False):
        specs["q_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
        specs["k_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
    return specs


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B,S,D] x [D,N,hd] -> [B,S,N,hd] as one matrix product."""
    B, S, D = x.shape
    return (x.reshape(B * S, D) @ w.reshape(D, -1)).reshape(
        B, S, w.shape[1], w.shape[2])


def _project_qkv(params, x, positions, cfg, use_rope: bool, rope=None):
    """x: [B,S,D] -> q [B,S,H,hd], k,v [B,S,KV,hd] (rope applied;
    ``rope`` = precomputed ``common.rope_cos_sin(positions, ...)``)."""
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if "q_norm" in params:
        q = rms_normalize(q) * params["q_norm"].to(q.dtype)
        k = rms_normalize(k) * params["k_norm"].to(k.dtype)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta, rope)
        k = apply_rope(k, positions, cfg.rope_theta, rope)
    return q, k, v


def _out_proj(params, ctx, cfg):
    """ctx: [B,S,H,hd] -> [B,S,D]."""
    B, S, H, hd = ctx.shape
    wo = params["wo"]
    y = (ctx.reshape(B * S, H * hd) @ wo.reshape(H * hd, -1)).reshape(B, S, -1)
    if "bo" in params:
        y = y + params["bo"]
    return y


# ---------------------------------------------------------------------------
# Core attention math (pre-projected q/k/v)
# ---------------------------------------------------------------------------

def _attend(q, k, v, mask, scale):
    """q [B,Sq,KV,G,hd]; k,v [B,Sk,KV,hd]; mask broadcastable to
    [B,KV,G,Sq,Sk].  fp32 in, fp32 out."""
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k) * scale
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v)


# ---------------------------------------------------------------------------
# Paged KV cache (block-table serving path)
# ---------------------------------------------------------------------------

def paged_cache_specs(cfg, num_pages: int, page_size: int,
                      kv_dtype: str = "fp32") -> Dict[str, ParamSpec]:
    """KV page pool for one attention layer (+1 trash page).

    ``fp32`` inherits the model dtype, ``bf16`` halves pool bytes,
    ``int8``/``fp8`` quarter them (a bf16 model: halve) and add parallel
    per-page-per-head fp32 scale pools ``k_scale``/``v_scale`` (fp32 for
    every model dtype), addressed by the same block table; COW page
    copies treat them as just another pool leaf."""
    kv_quant.resolve_kv_dtype(kv_dtype)
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    axes = ("pages", "page", "kv_heads", "head_dim")
    dt = None if kv_dtype == "fp32" else \
        str(kv_quant.pool_torch_dtype(kv_dtype, cfg.dtype)).split(".")[-1]
    specs = {
        "k": ParamSpec((num_pages + 1, page_size, KV, hd), axes,
                       init="zeros", dtype=dt),
        "v": ParamSpec((num_pages + 1, page_size, KV, hd), axes,
                       init="zeros", dtype=dt),
    }
    if kv_quant.is_quantized(kv_dtype):
        s_axes = ("pages", None, "kv_heads", None)
        for name in ("k_scale", "v_scale"):
            specs[name] = ParamSpec((num_pages + 1, 1, KV, 1), s_axes,
                                    init="zeros", dtype="float32")
    return specs


def _gather_pages(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """pool [P+1, page, KV, hd], block_tables [B, n] -> [B, n*page, KV, hd].

    On the card this is the ``paged_gather`` kernel; on the CPU its
    plain version (``ops`` dispatches on the device)."""
    return ops.paged_kv_gather(pool, block_tables)


def resolve_attn_backend(backend: str, device) -> str:
    """``auto`` -> the fused kernel on CUDA, the gather-then-attend path on
    the CPU (the reference's TPU/CPU split).  Explicit ``fused``/
    ``gather`` pass through — ``fused`` on the CPU runs the kernel's
    plain version."""
    if backend == "auto":
        return "fused" if torch.device(device).type == "cuda" else "gather"
    if backend not in ("fused", "gather"):
        raise ValueError(f"kernel_backend must be auto|fused|gather, got {backend!r}")
    return backend


def paged_attn_step(
    params: Dict,
    pool: Dict,
    block_tables: torch.Tensor,  # [B, n_pages] int32 page ids, -1 = unallocated
    x: torch.Tensor,  # [B, S, D] new tokens (decode: S=1; prefill chunk: S=chunk)
    pos: torch.Tensor,  # [B] int32 tokens already cached per request
    write_mask: torch.Tensor,  # [B, S] bool: which new tokens really exist
    cfg,
    kind: str = "global",
    backend: str = "gather",
    kv_dtype: str = "fp32",
    positions: Optional[torch.Tensor] = None,
    rope=None,
) -> Tuple[torch.Tensor, Dict]:
    """One paged step: project, scatter new KV into pages, attend.

    Token ``x[b, s]`` sits at absolute position ``pos[b] + s``; its K/V
    land in page ``block_tables[b, (pos[b]+s) // page]`` at offset
    ``(pos[b]+s) % page``.  Returns ``(y [B,S,D], pool)``; the pool is
    updated **in place** (the reference returns a new pool).
    ``positions`` (``pos[:, None] + arange(S)``) and ``rope``
    (``common.rope_cos_sin``) may be passed in precomputed: they are the
    same for every layer of a step.

    ``kv_dtype`` must match the pool (``paged_cache_specs``): for
    int8/fp8 the pool carries ``k_scale``/``v_scale`` leaves and both
    backends run the page-boundary quantization program of
    ``kernels/kv_quant.py``.

    * ``fused`` — ``ops.paged_attention``: the CUDA kernel on the card
      (scatter, online softmax over owned pages only).
    * ``gather`` — scatter (masked rows to the trash page), gather every
      request's full page view (``paged_gather`` kernel on the card),
      masked softmax.  Attends every ``block_tables.shape[1]`` pages.
    """
    quantized = kv_quant.is_quantized(kv_dtype)
    if quantized and "k_scale" not in pool:
        raise ValueError(
            f"kv_dtype={kv_dtype!r} needs scale pools; build the pool with "
            "paged_cache_specs(..., kv_dtype=...)")
    B, S, D = x.shape
    dev = x.device
    window = cfg.sliding_window if (kind == "local" and cfg.sliding_window) else 0
    if positions is None:
        positions = pos.long()[:, None] + torch.arange(S, device=dev)[None, :]
    q, k_new, v_new = _project_qkv(params, x, positions, cfg, use_rope=True,
                                   rope=rope)
    scale_k, scale_v = pool.get("k_scale"), pool.get("v_scale")

    if backend == "fused":
        out = ops.paged_attention(
            q, k_new, v_new, pool["k"], pool["v"], block_tables, pos,
            write_mask, scale_k=scale_k, scale_v=scale_v, kv_dtype=kv_dtype,
            window=window,
        )
        return _out_proj(params, out[0].to(x.dtype), cfg), pool

    ref.scatter_rows(pool["k"], pool["v"], block_tables, positions,
                     write_mask, k_new, v_new, scale_k=scale_k,
                     scale_v=scale_v, kv_dtype=kv_dtype)
    # attention math always in fp32 (bf16 pools round on write, upcast on
    # read; quantized pools read bits * scale — the same as the kernel)
    k_cache = ref.paged_view(pool["k"], scale_k, block_tables, _gather_pages)
    v_cache = ref.paged_view(pool["v"], scale_v, block_tables, _gather_pages)
    C = k_cache.shape[1]
    page = pool["k"].shape[1]
    KV, hd = k_new.shape[2], k_new.shape[3]
    H = cfg.num_heads
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, S, KV, G, hd)
    kpos = torch.arange(C, device=dev)[None, None, :]  # [1,1,C]
    qpos = positions[:, :, None]  # [B,S,1]
    valid = kpos <= qpos
    if window:
        valid &= kpos > qpos - window
    # pages never allocated hold stale/zero data — mask them out
    n = block_tables.shape[1]
    page_alloc = (block_tables >= 0)[:, :, None].expand(B, n, page)
    valid &= page_alloc.reshape(B, 1, C)
    ctx = _attend(qg, k_cache, v_cache, valid[:, None, None], scale)
    y = _out_proj(params, ctx.reshape(B, S, H, hd).to(x.dtype), cfg)
    return y, pool
