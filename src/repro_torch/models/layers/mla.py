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
from typing import Dict, Tuple

import torch

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


def _queries(params, x, positions, cfg, rope=None):
    """-> q_nope [B,S,H,dn], q_rope [B,S,H,dr]."""
    dn = cfg.qk_nope_head_dim
    if "w_dq" in params:
        cq = x @ params["w_dq"]
        cq = rms_normalize(cq) * params["q_norm"].to(x.dtype)
        q = _up(cq, params["w_uq"])
    else:
        q = _up(x, params["w_q"])
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
    reads keys ``[0, (i+1)*chunk)``).  Returns (y, (ckv, kr))."""
    B, S, D = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    scale = 1.0 / math.sqrt(dn + dr)

    q_nope, q_rope = _queries(params, x, positions, cfg, rope)
    ckv, kr = _compress_kv(params, x, positions, cfg, rope)
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
    return y, (ckv, kr)


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
) -> Tuple[torch.Tensor, Dict]:
    """Absorbed-form decode: scores and context live in the r-dim latent
    space.  x [B,1,D] at position ``pos`` (a host int).  The step's
    compressed KV is written into the cache **in place** before it is
    read, so two steps from one cache at one ``pos`` see the reference's
    values (as ``attention.attn_decode``)."""
    B = x.shape[0]
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    scale = 1.0 / math.sqrt(dn + dr)
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)

    q_nope, q_rope = _queries(params, x, positions, cfg, rope)  # [B,1,H,*]
    ckv_new, kr_new = _compress_kv(params, x, positions, cfg, rope)
    cache["ckv"][:, pos : pos + 1] = ckv_new
    cache["kr"][:, pos : pos + 1] = kr_new
    ckv, kr = cache["ckv"], cache["kr"]

    # absorb W_UK into the query: q_lat [B,1,H,r]
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, params["w_uk"])
    s_lat = torch.einsum("bqhr,bsr->bhqs", q_lat, ckv)
    s_rope = torch.einsum("bqhk,bsk->bhqs", q_rope, kr)
    scores = (s_lat + s_rope).float() * scale
    valid = torch.arange(ckv.shape[1], device=x.device) <= pos
    scores = torch.where(valid[None, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx_lat = torch.einsum("bhqs,bsr->bqhr", probs, ckv)  # [B,1,H,r]
    ctx = torch.einsum("bqhr,rhk->bqhk", ctx_lat, params["w_uv"])  # [B,1,H,dv]
    y = torch.einsum("bqhk,hkd->bqd", ctx, params["wo"])  # [B,1,D]
    return y, cache
