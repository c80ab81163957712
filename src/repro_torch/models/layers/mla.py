"""Multi-head Latent Attention (DeepSeek-V2/V3) (port of
``repro/models/layers/mla.py``).

Prefill uses the expanded form; decode uses the **absorbed** form against
the compressed cache (``ckv`` [B,S,r] + the shared rope key ``kr``
[B,S,dr]): W_UK folds into the query and W_UV into the output, so a step
reads r + dr numbers per cached token instead of 2·H·hd.

RoPE rotates only the ``qk_rope_head_dim`` dims of each query head and
the one shared key, so MLA takes its cos/sin at that width (``rope`` =
``common.rope_cos_sin(positions, cfg.qk_rope_head_dim, ...)``, computed
once per pass).  Scores and softmax run in fp32, the products in the
activation dtype, as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed import sharding as shlib
from repro_torch.models.common import apply_rope, rms_normalize
from repro_torch.models.param import ParamSpec

NEG_INF = -2.0e38


def mla_specs(cfg) -> Dict[str, ParamSpec]:
    D, H = cfg.d_model, cfg.num_heads
    qr, r = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    specs = {
        "w_dkv": ParamSpec((D, r), ("embed", "lora")),
        "w_kr": ParamSpec((D, dr), ("embed", "head_dim")),
        "kv_norm": ParamSpec((r,), ("lora",), init="ones"),
        "w_uk": ParamSpec((r, H, dn), ("lora", "heads", "head_dim")),
        "w_uv": ParamSpec((r, H, dv), ("lora", "heads", "head_dim")),
        "wo": ParamSpec((H, dv, D), ("heads", "head_dim", "embed")),
    }
    if qr:
        specs.update(
            w_dq=ParamSpec((D, qr), ("embed", "lora")),
            q_norm=ParamSpec((qr,), ("lora",), init="ones"),
            w_uq=ParamSpec((qr, H, dn + dr), ("lora", "heads", "head_dim")),
        )
    else:
        specs["w_q"] = ParamSpec((D, H, dn + dr), ("embed", "heads", "head_dim"))
    return specs


def _up(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B,S,r] x [r,H,k] -> [B,S,H,k] as one matrix product."""
    B, S, _ = x.shape
    return (x @ w.reshape(w.shape[0], -1)).reshape(B, S, w.shape[1], w.shape[2])


def _enter(x, split: bool):
    return shlib.block_in(x) if split else x


def _queries(params, x, positions, cfg, rope=None, split: bool = False):
    """-> q_nope [B,S,H,dn], q_rope [B,S,H,dr].  ``split``: the heads are
    split over ``model`` on a training mesh (the replicated query
    compression enters the split up-projection)."""
    dn = cfg.qk_nope_head_dim
    if "w_dq" in params:
        cq = x @ params["w_dq"]
        cq = rms_normalize(cq) * params["q_norm"].to(x.dtype)
        q = _up(_enter(cq, split), params["w_uq"])
    else:
        q = _up(_enter(x, split), params["w_q"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta, rope)
    return q_nope, q_rope


def _compress_kv(params, x, positions, cfg, rope=None):
    """-> c_kv [B,S,r] (normalized), k_rope [B,S,dr] (rotated, shared)."""
    ckv = x @ params["w_dkv"]
    ckv = rms_normalize(ckv) * params["kv_norm"].to(x.dtype)
    kr = x @ params["w_kr"]
    kr = apply_rope(kr[:, :, None, :], positions, cfg.rope_theta, rope)[:, :, 0]
    return ckv, kr


def mla_forward(
    params: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg,
    q_chunk: int = 1024,
    rope=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Expanded-form MLA for prefill, chunked over queries (chunk ``i``
    reads keys ``[0, (i+1)*chunk)``).  Returns (y, (ckv, kr)).

    On a training mesh whose rules split the heads over ``model``, the
    replicated compressions (``ckv``, the shared rope key, the query
    compression) enter this rank's heads and the out-projection's
    partial sums are reduced over ``model``."""
    B, S, D = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    scale = 1.0 / math.sqrt(dn + dr)
    split = shlib.model_split(params["w_uk"].shape[1], cfg.num_heads)

    q_nope, q_rope = _queries(params, x, positions, cfg, rope, split)
    ckv_c, kr_c = _compress_kv(params, x, positions, cfg, rope)
    ckv, kr = _enter(ckv_c, split), _enter(kr_c, split)
    k_nope = _up(ckv, params["w_uk"])
    v = _up(ckv, params["w_uv"])

    chunk = min(q_chunk, S)
    pad = (-S) % chunk
    if pad:
        q_nope = torch.cat([q_nope, q_nope.new_zeros((B, pad) + q_nope.shape[2:])], 1)
        q_rope = torch.cat([q_rope, q_rope.new_zeros((B, pad) + q_rope.shape[2:])], 1)
    outs = []
    for i in range((S + pad) // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        k_end = min(S, (i + 1) * chunk)
        s_n = torch.einsum("bqhk,bshk->bhqs", q_nope[:, sl], k_nope[:, :k_end])
        s_r = torch.einsum("bqhk,bsk->bhqs", q_rope[:, sl], kr[:, :k_end])
        scores = (s_n + s_r).float() * scale
        qpos = i * chunk + torch.arange(chunk, device=x.device)[:, None]
        kpos = torch.arange(k_end, device=x.device)[None, :]
        scores = torch.where((kpos <= qpos)[None, None], scores,
                             torch.full_like(scores, NEG_INF))
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhqs,bshk->bqhk", probs, v[:, :k_end]))
    ctx = torch.cat(outs, dim=1)[:, :S]  # [B,S,H,dv]
    H, dv = ctx.shape[2], ctx.shape[3]
    y = (ctx.reshape(B * S, H * dv) @ params["wo"].reshape(H * dv, D)).reshape(B, S, D)
    if shlib.active_rules()[0] is not None:
        y = shlib.block_out(y, split)
    return y, (ckv_c, kr_c)


def mla_cache_specs(cfg, batch: int, max_len: int) -> Dict[str, ParamSpec]:
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    return {
        "ckv": ParamSpec((batch, max_len, r), ("batch", "kv_seq", "lora"), init="zeros"),
        "kr": ParamSpec((batch, max_len, dr), ("batch", "kv_seq", "head_dim"), init="zeros"),
    }


def mla_fill_cache(cache: Dict, ckv: torch.Tensor, kr: torch.Tensor) -> Dict:
    """Write a prefill's compressed KV at positions ``[0, S)``, in place."""
    S = ckv.shape[1]
    cache["ckv"][:, :S] = ckv
    cache["kr"][:, :S] = kr
    return cache


def mla_decode(
    params: Dict,
    cache: Dict,
    x: torch.Tensor,
    pos: int,
    cfg,
    rope=None,
    wspec: Optional[Dict] = None,
    cspec: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Absorbed-form decode: scores and context live in the r-dim latent
    space.  x [B,1,D] at position ``pos`` (a host int).  The step's
    compressed KV is written into the cache **in place** before it is
    read, so two steps from one cache at one ``pos`` see the reference's
    values (as ``attention.attn_decode``).

    On a serving mesh ``wspec`` / ``cspec`` are the resolved specs of the
    weights and of the latent cache block, and the collectives go where
    they split a dimension (``attention.attn_decode`` does the same for
    GQA; without specs every one is the identity).  The latent cache has
    no heads: where its sequence axis is split every rank scores all
    heads over its block (the absorbed queries gathered over the head
    split) and the ranks merge by log-sum-exp; otherwise each rank keeps
    its heads.  A split ``head_dim`` of the shared rope key sums its
    partial scores over ranks that score the same heads (the heads are
    gathered over those axes first).  The context goes back to the heads of ``w_uv`` and
    the out-projection's partial sums are reduced."""
    from repro_torch.models.layers.attention import (split_softmax_ctx,
                                                     sum_scores)

    ws, cs = wspec or {}, cspec or {}
    ax = shlib.split_axes
    B = x.shape[0]
    dn = cfg.qk_nope_head_dim
    scale = 1.0 / math.sqrt(dn + cfg.qk_rope_head_dim)
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    if "w_dq" in params:
        cq = x @ params["w_dq"]
        cq = rms_normalize(cq) * params["q_norm"].to(x.dtype)
        q, qs = _up(cq, params["w_uq"]), ws.get("w_uq")
    else:
        q, qs = _up(x, params["w_q"]), ws.get("w_q")
    q = shlib.gather_dim(q, 3, ax(qs, 2))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta, rope)
    ckv_new = x @ params["w_dkv"]
    ckv_new = rms_normalize(ckv_new) * params["kv_norm"].to(x.dtype)
    kr_new = shlib.gather_dim(x @ params["w_kr"], 2, ax(ws.get("w_kr"), 1))
    kr_new = apply_rope(kr_new[:, :, None, :], positions, cfg.rope_theta,
                        rope)[:, :, 0]

    seq_axes, kr_hd = ax(cs.get("ckv"), 1), ax(cs.get("kr"), 2)
    mesh, _ = shlib.active_rules()
    C_loc = cache["ckv"].shape[1]
    off = (mesh.coord(seq_axes) if seq_axes else 0) * C_loc
    if off <= pos < off + C_loc:  # this rank's block holds the new token
        cache["ckv"][:, pos - off: pos - off + 1] = ckv_new
        cache["kr"][:, pos - off: pos - off + 1] = shlib.slice_dim(kr_new, 2, kr_hd)
    ckv, kr = cache["ckv"], cache["kr"]

    # absorb W_UK into the query: q_lat [B,1,H,r]
    uk = ws.get("w_uk")
    q_nope = shlib.relayout(q_nope, {2: (ax(qs, 1), ax(uk, 1)),
                                     3: ((), ax(uk, 2))})
    q_lat = shlib.psum(torch.einsum("bqhn,rhn->bqhr", q_nope, params["w_uk"]),
                       ax(uk, 2))
    # the heads each rank scores: all of them where the sequence is split;
    # none split over the rope key's head_dim axes, whose partial scores
    # are summed over the ranks (each must hold the same heads)
    heads = () if seq_axes else tuple(a for a in ax(uk, 1) if a not in kr_hd)
    q_lat = shlib.relayout(q_lat, {2: (ax(uk, 1), heads)})
    q_rope = shlib.relayout(q_rope, {2: (ax(qs, 1), heads), 3: ((), kr_hd)})
    s_lat = torch.einsum("bqhr,bsr->bhqs", q_lat, ckv)
    s_rope = sum_scores(torch.einsum("bqhk,bsk->bhqs", q_rope, kr), kr_hd)
    scores = (s_lat + s_rope).float() * scale
    valid = (off + torch.arange(C_loc, device=x.device) <= pos)[None, None, None]
    if seq_axes:
        ctx_lat = split_softmax_ctx(scores, valid, ckv, seq_axes, "bhqs,bsr->bqhr")
    else:
        scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx_lat = torch.einsum("bhqs,bsr->bqhr", probs, ckv)  # [B,1,H,r]
    uv, wo = ws.get("w_uv"), ws.get("wo")
    ctx_lat = shlib.relayout(ctx_lat, {2: (heads, ax(uv, 1))})
    ctx = torch.einsum("bqhr,rhk->bqhk", ctx_lat, params["w_uv"])  # [B,1,H,dv]
    ctx = shlib.relayout(ctx, {2: (ax(uv, 1), ax(wo, 0)),
                               3: (ax(uv, 2), ax(wo, 1))})
    y = torch.einsum("bqhk,hkd->bqd", ctx, params["wo"])  # [B,1,D]
    return shlib.psum(y, ax(wo, 0) + ax(wo, 1)), cache
