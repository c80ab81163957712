"""GQA/MQA attention (port of ``repro/models/layers/attention.py``).

Two cache forms:

* **contiguous** (``GenerationEngine``, the evaluation protocols):
  exact chunked-causal prefill (``chunked_attention``) and a decode
  cache of ``[B, C, KV, hd]`` per layer, a ring buffer of ``window``
  slots for sliding-window layers, optionally int8 with per-(token,
  head) scales (``cfg.kv_cache_int8``).  Attention here is plain
  PyTorch, as it is plain ``jnp`` in the reference.
* **paged** (``PagedServer``): the pool of one attention layer holds
  ``num_pages + 1`` fixed-size pages shared by all live requests; the
  extra final page is a write-off ("trash") target for padded tokens on
  the gather path.  A request's logical KV positions map to pool pages
  through its block table (page ids, -1 = unallocated).

All softmax math runs in fp32; the products stay in the activation
dtype, as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.sharding import psum_if_tp
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


def _project_qkv(params, x, positions, cfg, use_rope: bool, rope=None,
                 x_kv=None):
    """x: [B,S,D] -> q [B,S,H,hd], k,v [B,S,KV,hd] (rope applied;
    ``rope`` = precomputed ``common.rope_cos_sin(positions, ...)``;
    ``x_kv``, if given, is what the key/value projections read)."""
    x_kv = x if x_kv is None else x_kv
    q = _proj(x, params["wq"])
    k = _proj(x_kv, params["wk"])
    v = _proj(x_kv, params["wv"])
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


def _out_proj(params, ctx, cfg, split: bool = False, axes=()):
    """ctx: [B,S,H,hd] -> [B,S,D].

    Under tensor parallelism (``sharding.tp_axis`` active, ``split`` on a
    training mesh, or ``axes``: the axes a serving mesh splits ``wo``'s
    heads and ``head_dim`` over) the contraction is a partial sum per
    rank — all-reduced before the (replicated) bias, so the bias counts
    once.  Every attention path (paged, chunked, decode) ends here."""
    B, S, H, hd = ctx.shape
    wo = params["wo"]
    y = (ctx.reshape(B * S, H * hd) @ wo.reshape(H * hd, -1)).reshape(B, S, -1)
    y = shlib.psum(psum_if_tp(y), axes)
    if shlib.active_rules()[0] is not None and not axes:
        y = shlib.block_out(y, split)
    if "bo" in params:
        y = y + params["bo"]
    return y


# ---------------------------------------------------------------------------
# Core attention math (pre-projected q/k/v)
# ---------------------------------------------------------------------------

def _attend(q, k, v, mask, scale):
    """q [B,Sq,KV,G,hd]; k,v [B,Sk,KV,hd]; mask broadcastable to
    [B,KV,G,Sq,Sk].  Scores and softmax in fp32, products in the inputs'
    dtype; returns ctx in v's dtype."""
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k).float() * scale
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: int = 0,
    q_chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """Exact attention over full sequences, chunked over queries.

    q: [B,S,H,hd]; k,v: [B,Sk,KV,hd].  Returns [B,S,H,hd].  Chunk ``i``
    reads only keys ``[k_start, (i+1)*chunk)`` (``k_start`` clamped by
    the sliding window), so causal work is ~S^2/2.  S is padded to a
    multiple of the chunk; ``q_offset`` is the absolute position of
    q[:, 0] relative to k[:, 0]."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, S, KV, G, hd)

    chunk = min(q_chunk, S)
    if S % chunk != 0:  # pad to a multiple (rare: tiny shapes)
        pad = chunk - S % chunk
        qg = torch.cat([qg, qg.new_zeros((B, pad, KV, G, hd))], dim=1)
    n_chunks = qg.shape[1] // chunk

    outs = []
    for i in range(n_chunks):
        q_i = qg[:, i * chunk : (i + 1) * chunk]
        q_lo = q_offset + i * chunk
        q_hi = q_lo + chunk
        if causal:
            k_end = min(Sk, q_hi)
            k_start = max(0, q_lo - window) if window else 0
        else:
            k_start, k_end = 0, Sk
        # the mask is built where the scores live (no host array, no copy)
        qpos = q_lo + torch.arange(chunk, device=q.device)[:, None]
        kpos = k_start + torch.arange(k_end - k_start, device=q.device)[None, :]
        if causal:
            m = kpos <= qpos
            if window:
                m &= kpos > qpos - window
        else:
            m = torch.ones((chunk, k_end - k_start), dtype=torch.bool,
                           device=q.device)
        mask = m[None, None, None]
        outs.append(_attend(q_i, k[:, k_start:k_end], v[:, k_start:k_end],
                            mask, scale))
    out = torch.cat(outs, dim=1)[:, :S]
    return out.reshape(B, S, H, hd)


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill / teacher-forced evaluation)
# ---------------------------------------------------------------------------

def attn_forward(params: Dict, x: torch.Tensor, positions: torch.Tensor, cfg,
                 kind: str = "global", q_chunk: int = 1024, rope=None
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Returns (out [B,S,D], (k, v) for cache construction).  ``rope``:
    precomputed ``common.rope_cos_sin(positions, ...)``.

    On a training mesh whose rules split the heads over ``model`` this
    rank attends with its block of query heads and the out-projection's
    partial sums are reduced over ``model``.  When the KV heads are split
    too, each rank holds the KV heads of its query heads; when their axis
    was dropped (a KV count the axis does not divide), every rank projects
    all KV heads and keeps, for each local query head, its group's."""
    use_rope = cfg.family != "encoder"
    split = shlib.model_split(params["wq"].shape[1], cfg.num_heads)
    if split:
        xs = shlib.block_in(x)
        kv_split = shlib.model_split(params["wk"].shape[1], cfg.num_kv_heads)
        q, k_out, v_out = _project_qkv(params, xs, positions, cfg, use_rope,
                                       rope=rope, x_kv=xs if kv_split else x)
        k, v = (k_out, v_out) if kv_split else \
            _local_kv_heads(q.shape[2], k_out, v_out, cfg)
    else:
        q, k, v = _project_qkv(params, x, positions, cfg, use_rope, rope=rope)
        k_out, v_out = k, v
    window = cfg.sliding_window if kind == "local" else 0
    ctx = chunked_attention(q, k, v, causal=cfg.is_causal, window=window,
                            q_chunk=q_chunk)
    # the cache material: the KV heads this rank projected
    return _out_proj(params, ctx, cfg, split), (k_out, v_out)


def _local_kv_heads(h_local: int, k, v, cfg):
    """Whole K/V [B,S,KV,hd] -> the KV head of each of this rank's
    ``h_local`` query heads ([B,S,h_local,hd], one query head per KV
    head).  Only the local heads read them, so their gradient is a
    partial sum: they enter the split computation here."""
    mesh, _ = shlib.active_rules()
    G = cfg.num_heads // cfg.num_kv_heads
    heads = mesh.coord("model") * h_local + torch.arange(h_local, device=k.device)
    idx = heads // G
    k = shlib.block_in(k).index_select(2, idx)
    v = shlib.block_in(v).index_select(2, idx)
    return k, v


# ---------------------------------------------------------------------------
# Contiguous decode cache
# ---------------------------------------------------------------------------

def cache_capacity(cfg, kind: str, max_len: int) -> int:
    if kind == "local" and cfg.sliding_window:
        return min(cfg.sliding_window, max_len)
    return max_len


def _kv_int8(cfg) -> bool:
    return getattr(cfg, "kv_cache_int8", False)


def quantize_kv(x: torch.Tensor, axes=()) -> Tuple[torch.Tensor, torch.Tensor]:
    """[...,hd] -> (int8 [...,hd], f32 scale [...,1]).  Per-(token, head).

    ``axes``: the mesh axes ``x``'s ``head_dim`` is split over (a block of
    each head on this rank): the block's amax is all-reduced to the
    head's max first, so the scale is the whole head's (replicated over
    ``axes``) and the codes are the whole head's codes of this block."""
    xf = x.float()
    s = shlib.pmax(xf.abs().amax(dim=-1, keepdim=True), axes) / 127.0
    q = torch.round(xf / torch.clamp(s, min=1e-8)).to(torch.int8)
    return q, s


def dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * s).to(dtype)


def init_cache_specs(cfg, kind: str, batch: int, max_len: int) -> Dict[str, ParamSpec]:
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    C = cache_capacity(cfg, kind, max_len)
    seq_ax = "window" if (kind == "local" and cfg.sliding_window) else "kv_seq"
    axes = ("batch", seq_ax, "kv_heads", "head_dim")
    if _kv_int8(cfg):
        # int8 KV cache: halves (bf16) or quarters (fp32) the cache read
        # that dominates long-context decode; scales are 1/hd of it
        specs = {name: ParamSpec((batch, C, KV, hd), axes, init="zeros",
                                 dtype="int8") for name in ("k", "v")}
        for name in ("k_scale", "v_scale"):
            specs[name] = ParamSpec((batch, C, KV, 1), axes, init="zeros",
                                    dtype="float32")
        return specs
    return {name: ParamSpec((batch, C, KV, hd), axes, init="zeros")
            for name in ("k", "v")}


def fill_cache(cache: Dict, k: torch.Tensor, v: torch.Tensor) -> Dict:
    """Write prefill K/V [B,S,...] into a cache buffer, **in place** (the
    reference returns a new one).  For ring (window) caches the last C
    entries land at slot ``pos % C``."""
    C = cache["k"].shape[1]
    S = k.shape[1]
    entries = {"k": k, "v": v}
    if cache["k"].dtype == torch.int8:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        entries = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    for name, val in entries.items():
        buf = cache[name]
        if S <= C:
            buf[:, :S] = val.to(buf.dtype)
        else:
            slots = torch.from_numpy(np.arange(S - C, S) % C).to(buf.device)
            buf[:, slots] = val[:, S - C:].to(buf.dtype)
    return cache


def sum_scores(s: torch.Tensor, axes) -> torch.Tensor:
    """Scores whose contraction (``head_dim``) is split over ``axes``:
    the ranks' partial q.k summed before the softmax."""
    return shlib.psum(s, axes)


def split_softmax_ctx(scores: torch.Tensor, valid: torch.Tensor, v, seq_axes,
                      pv: str) -> torch.Tensor:
    """``softmax(scores) @ v`` over keys split along ``seq_axes`` (the
    flash-decoding merge): each rank holds its block's scores (fp32,
    ``[..., C_local]``) and values; the max is all-reduced, each rank
    rescales by it, the sums of exponentials and the partial contexts
    are all-reduced.  ``pv`` is the einsum of the probabilities and
    ``v``; the products run in ``v``'s dtype, as the unsplit softmax's."""
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    m = shlib.pmax(scores.amax(dim=-1, keepdim=True), seq_axes)
    p = torch.exp(scores - m)
    l = shlib.psum(p.sum(dim=-1, keepdim=True), seq_axes)
    ctx = torch.einsum(pv, (p / l).to(v.dtype), v)
    return shlib.psum(ctx, seq_axes)


def _full(t: torch.Tensor, spec) -> torch.Tensor:
    """A small leaf (bias, norm scale) gathered along every split dim."""
    for d in range(t.dim()):
        t = shlib.gather_dim(t, d, shlib.split_axes(spec, d))
    return t


def attn_decode(params: Dict, cache: Dict, x: torch.Tensor, pos: int, cfg,
                kind: str = "global", rope=None, wspec: Optional[Dict] = None,
                cspec: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  x: [B,1,D]; ``pos``: tokens so far (a host int).

    The new K/V are written into the cache **in place** at slot ``pos``
    (ring: ``pos % C``; int8: quantized, then the whole cache read back
    dequantized) before attending over the slots at or before ``pos``.
    Callers that run two steps from one cache (``evaluate.
    classification_sim``) rely on that order: each step rewrites slot
    ``pos`` before reading it, and no slot it reads is one another step
    at the same ``pos`` writes.

    On a serving mesh (``sharding.axis_rules``, ``launch.cells``) this is
    one rank's shard: ``params`` and ``cache`` hold its blocks, ``wspec``
    and ``cspec`` the resolved specs of the layer's weights and of its
    cache (``("batch", "kv_seq" | "window", "kv_heads", "head_dim")``),
    and ``x`` [B_local,1,D] is replicated over the model axes.  Each
    collective goes where those specs split a dimension; without specs
    (or on one rank) every one is the identity.

    * q and the new K/V are gathered along ``head_dim`` where the weights
      split it (RoPE and the q/k norms need whole heads), then cut to the
      cache block's KV heads and ``head_dim`` (query heads: those of the
      block's KV heads).
    * Only the rank whose sequence block holds the slot writes the token;
      an int8 cache split over ``head_dim`` quantizes each block with the
      whole head's scale (``quantize_kv``'s all-reduced amax).
    * ``head_dim`` split: the partial q.k are summed before the softmax
      (``sum_scores``) and the context stays split.
    * ``kv_seq`` / ``window`` split: each rank attends over its block and
      the ranks merge by log-sum-exp (``split_softmax_ctx``).
    * The context goes to the out-projection's layout, whose partial sums
      are reduced over its split axes before the bias.
    Returns (y [B,1,D], cache)."""
    ws, cs = wspec or {}, (cspec or {}).get("k")
    ax = shlib.split_axes
    B = x.shape[0]
    KV, hd, H = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q = _proj(x, params["wq"])
    k_new = _proj(x, params["wk"])
    v_new = _proj(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k_new = k_new + params["bk"]
        v_new = v_new + params["bv"]
    q = shlib.gather_dim(q, 3, ax(ws.get("wq"), 2))
    k_new = shlib.gather_dim(k_new, 3, ax(ws.get("wk"), 2))
    v_new = shlib.gather_dim(v_new, 3, ax(ws.get("wv"), 2))
    if "q_norm" in params:
        q = rms_normalize(q) * _full(params["q_norm"],
                                     ws.get("q_norm")).to(q.dtype)
        k_new = rms_normalize(k_new) * _full(params["k_norm"],
                                             ws.get("k_norm")).to(k_new.dtype)
    q = apply_rope(q, positions, cfg.rope_theta, rope)
    k_new = apply_rope(k_new, positions, cfg.rope_theta, rope)

    seq_axes, kv_axes, hd_axes = ax(cs, 1), ax(cs, 2), ax(cs, 3)
    k_new = shlib.relayout(k_new, {2: (ax(ws.get("wk"), 1), kv_axes),
                                   3: ((), hd_axes)})
    v_new = shlib.relayout(v_new, {2: (ax(ws.get("wv"), 1), kv_axes),
                                   3: ((), hd_axes)})
    q = shlib.relayout(q, {2: (ax(ws.get("wq"), 1), kv_axes),
                           3: ((), hd_axes)})

    mesh, _ = shlib.active_rules()
    C_loc = cache["k"].shape[1]
    C = C_loc * (mesh.extent(seq_axes) if seq_axes else 1)
    off = (mesh.coord(seq_axes) if seq_axes else 0) * C_loc
    is_ring = bool(kind == "local" and cfg.sliding_window
                   and C == cfg.sliding_window)
    slot = pos % C if is_ring else min(pos, C - 1)
    int8 = cache["k"].dtype == torch.int8
    if off <= slot < off + C_loc:  # this rank's block holds the new token
        j = slot - off
        if int8:
            for name, val in zip(("k", "k_scale", "v", "v_scale"),
                                 quantize_kv(k_new, hd_axes)
                                 + quantize_kv(v_new, hd_axes)):
                cache[name][:, j:j + 1] = val
        else:
            cache["k"][:, j:j + 1] = k_new
            cache["v"][:, j:j + 1] = v_new
    if int8:
        k_cache = dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        v_cache = dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        k_cache, v_cache = cache["k"], cache["v"]

    kv_loc, hd_loc = k_cache.shape[2], k_cache.shape[3]
    G = H // KV
    qg = q.reshape(B, 1, kv_loc, G, hd_loc)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k_cache).float()
    scores = sum_scores(scores, hd_axes) * (1.0 / math.sqrt(hd))
    slots_idx = off + torch.arange(C_loc, device=x.device)
    if is_ring:
        # ring slot s holds global position: the latest p <= pos with p%C==s
        valid = (pos - slots_idx) % C < min(pos + 1, C)  # age < n_valid
    else:
        valid = slots_idx <= pos
    if seq_axes:
        ctx = split_softmax_ctx(scores, valid, v_cache, seq_axes,
                                "bkgqs,bskh->bqkgh")
    else:  # _attend's softmax, on the summed scores
        probs = torch.softmax(torch.where(
            valid, scores, torch.full_like(scores, NEG_INF)), dim=-1)
        ctx = torch.einsum("bkgqs,bskh->bqkgh", probs.to(v_cache.dtype), v_cache)
    ctx = ctx.reshape(B, 1, kv_loc * G, hd_loc)
    o_heads, o_hd = ax(ws.get("wo"), 0), ax(ws.get("wo"), 1)
    ctx = shlib.relayout(ctx, {2: (kv_axes, o_heads), 3: (hd_axes, o_hd)})
    return _out_proj(params, ctx, cfg, axes=o_heads + o_hd), cache


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
