"""Deployment-time model transforms (port of
``repro/distributed/transforms.py``).

``pad_attention_heads``: zero-pad the *query heads per KV group* so the
total head count becomes TP-shardable (llava: 56H = 8KV x 7G -> 64H =
8KV x 8G on a 16-way model axis).  Exactly output-preserving: the padded
q heads' out-projection rows are zero, so they contribute nothing, and
the q->kv group mapping of the original heads is unchanged.  Costs
(G'/G - 1) extra attention FLOPs; buys sharded attention weights with no
gathers.  KV heads are left as they are.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def pad_attention_heads(cfg, tp: int = 16):
    """Config with q-heads-per-group padded so num_heads % tp == 0."""
    if cfg.num_heads == 0 or cfg.num_heads % tp == 0:
        return cfg
    kv = max(cfg.num_kv_heads, 1)
    if cfg.num_heads % kv:
        raise ValueError(f"{cfg.name}: {cfg.num_heads} heads in {kv} KV groups")
    g = cfg.num_heads // kv
    g2 = g
    while (kv * g2) % tp != 0:
        g2 += 1
    return cfg.replace(name=cfg.name + "+padheads", num_heads=kv * g2)


def pad_attention_params(params_attn: Dict[str, torch.Tensor], cfg,
                         padded) -> Dict[str, torch.Tensor]:
    """Zero-pad one attention block's q/out weights to the padded head
    count, preserving the per-group head order."""
    kv = max(cfg.num_kv_heads, 1)
    g = cfg.num_heads // kv
    g2 = padded.num_heads // kv
    D, _, hd = params_attn["wq"].shape
    out = dict(params_attn)
    wq = params_attn["wq"].reshape(D, kv, g, hd)
    out["wq"] = F.pad(wq, (0, 0, 0, g2 - g)).reshape(D, kv * g2, hd)
    wo = params_attn["wo"].reshape(kv, g, hd, D)
    out["wo"] = F.pad(wo, (0, 0, 0, 0, 0, g2 - g)).reshape(kv * g2, hd, D)
    if "bq" in params_attn:
        bq = params_attn["bq"].reshape(kv, g, hd)
        out["bq"] = F.pad(bq, (0, 0, 0, g2 - g)).reshape(kv * g2, hd)
    return out
