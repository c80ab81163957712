"""RG-LRU recurrent block (RecurrentGemma / DeepMind-Griffin architecture;
port of ``repro/models/layers/rglru.py``).

    r_t = sigmoid(W_a x_t)                 recurrence gate
    i_t = sigmoid(W_i x_t)                 input gate
    a_t = exp(-c * softplus(lambda) * r_t)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full-sequence recurrence is a log-depth associative scan in fp32
(``associative_scan``: the odd/even recursion of ``jax.lax.
associative_scan``, written with torch ops, so its products are taken in
the reference's order); decode is the O(1) recurrence.  The block wraps
the LRU with an input projection + causal depthwise conv (no
activation) and a GeLU gate branch, per the RecurrentGemma recurrent
block.  The cache holds the fp32 ``h`` [B, W] and the last
``conv_width - 1`` **pre-conv** inputs; ``rglru_decode`` writes both in
place.

Split over ``model`` (the reference's rules: ``lru`` on ``model``), a
rank holds a contiguous block of the LRU width in every leaf, and the
block-diagonal gates' blocks of it (whole blocks: the model axis must
divide ``lru_blocks``).  Everything but the projections is elementwise
along the width, so the block runs on its columns alone: ``x`` enters
through ``sharding.block_in`` and the row-split ``w_out``'s partial sums
leave through ``block_out``.  The cache holds the block's ``h`` and conv
tail columns.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as shlib
from repro_torch.models.common import activation_fn
from repro_torch.models.layers.ssm import causal_conv, conv_tail
from repro_torch.models.param import ParamSpec

_C = 8.0  # RG-LRU decay sharpness constant


def rglru_specs(cfg) -> Dict[str, ParamSpec]:
    """Gate matrices are BLOCK-DIAGONAL (the official RecurrentGemma
    parameterization): ``lru_blocks`` blocks of ``[W/nb, W/nb]``."""
    D, W = cfg.d_model, cfg.lru_width
    nb = min(getattr(cfg, "lru_blocks", 16), W)
    wb = W // nb
    return {
        "w_x": ParamSpec((D, W), ("embed", "lru")),
        "w_y": ParamSpec((D, W), ("embed", "lru")),
        "conv_w": ParamSpec((cfg.conv_width, W), ("conv", "lru")),
        "conv_b": ParamSpec((W,), ("lru",), init="zeros"),
        "w_a": ParamSpec((nb, wb, wb), ("lru", None, None), init="small"),
        "b_a": ParamSpec((W,), ("lru",), init="zeros"),
        "w_i": ParamSpec((nb, wb, wb), ("lru", None, None), init="small"),
        "b_i": ParamSpec((W,), ("lru",), init="zeros"),
        "lam": ParamSpec((W,), ("lru",), init="ones"),
        "w_out": ParamSpec((W, D), ("lru", "embed")),
    }


def _gates(params, xb):
    """xb: [...,W] -> (a, gated_input) in fp32. Block-diagonal gates."""
    f32 = torch.float32
    nb, wb, _ = params["w_a"].shape
    xr = xb.reshape(*xb.shape[:-1], nb, wb)

    def gate(w, b):
        g = torch.einsum("...bw,bwv->...bv", xr, w).reshape(xb.shape)
        return torch.sigmoid(g.to(f32) + b.to(f32))

    r = gate(params["w_a"], params["b_a"])
    i = gate(params["w_i"], params["b_i"])
    log_a = -_C * F.softplus(params["lam"].to(f32)) * r  # [..., W] <= 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-9)) * (i * xb.to(f32))
    return a, b


def _combine(left, right):
    a_l, b_l = left
    a_r, b_r = right
    return a_l * a_r, b_l * a_r + b_r


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` over dim 1, as
    ``jax.lax.associative_scan(combine, (a, b), axis=1)``: combine
    adjacent pairs, scan the half-length sequence by recursion (the odd
    outputs), combine each with the next input (the even outputs),
    interleave.  ~10 ops per level, log2(S) levels.  Returns (A, h)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2]))
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)

    def interleave(even, odd):
        out = even.new_empty((even.shape[0], n) + even.shape[2:])
        out[:, 0::2] = even
        out[:, 1::2] = odd
        return out

    return interleave(ea, oa), interleave(eb, ob)


def _split(params, cfg) -> bool:
    """Whether this rank holds a ``model`` block of the LRU width; refuses
    a split that cuts through the gates' blocks."""
    W = params["w_x"].shape[1]
    if not shlib.model_split(W, cfg.lru_width):
        return False
    nb, wb, _ = params["w_a"].shape
    if nb * wb != W:
        raise NotImplementedError(
            f"{cfg.name}: the RG-LRU width is split over 'model' but its "
            f"{min(getattr(cfg, 'lru_blocks', 16), cfg.lru_width)} gate "
            f"blocks are not divisible by the axis (ROADMAP, Queue A item 4)")
    return True


def _out(params, y, split: bool):
    out = y @ params["w_out"]
    if shlib.active_rules()[0] is None:
        return out
    return shlib.block_out(out, split)


def rglru_forward(params: Dict, x: torch.Tensor, cfg, init_h=None
                  ) -> Tuple[torch.Tensor, Dict]:
    """x: [B,S,D] -> (y [B,S,D], cache material ``{h [B,W] fp32, conv
    [B,W-1,W]}``; split over ``model``: this rank's columns of both).
    ``init_h`` is folded into the first step: ``b_0 += a_0 * init_h``."""
    gelu = activation_fn("gelu")  # tanh approximation, as the reference
    split = _split(params, cfg)
    if split:
        x = shlib.block_in(x)
    xb = x @ params["w_x"]
    yb = gelu(x @ params["w_y"])
    tail = conv_tail(xb, cfg.conv_width)
    xb = causal_conv(xb, params["conv_w"], params["conv_b"])

    a, b = _gates(params, xb)  # fp32 [B,S,W]
    if init_h is not None:
        b = b.clone()
        b[:, 0] = b[:, 0] + a[:, 0] * init_h.to(torch.float32)
    _, h = associative_scan(a, b)
    y = h.to(x.dtype) * yb
    return _out(params, y, split), {"h": h[:, -1], "conv": tail}


def rglru_cache_specs(cfg, batch: int) -> Dict[str, ParamSpec]:
    W = cfg.lru_width
    return {
        "h": ParamSpec((batch, W), ("batch", "lru"), init="zeros", dtype="float32"),
        "conv": ParamSpec((batch, cfg.conv_width - 1, W), ("batch", "conv", "lru"),
                          init="zeros"),
    }


def rglru_decode(params: Dict, cache: Dict, x: torch.Tensor, cfg
                 ) -> Tuple[torch.Tensor, Dict]:
    """Single-step recurrence. x: [B,1,D].  The cache's ``h`` and ``conv``
    are advanced **in place** (see ``ssm.ssm_decode``)."""
    gelu = activation_fn("gelu")
    split = _split(params, cfg)
    if split:
        x = shlib.block_in(x)
    xb_new = x @ params["w_x"]  # [B,1,W]
    yb = gelu(x @ params["w_y"])
    win = torch.cat([cache["conv"].to(x.dtype), xb_new], dim=1)
    xb = (torch.einsum("bwc,wc->bc", win, params["conv_w"]) + params["conv_b"])[:, None]
    a, b = _gates(params, xb)  # [B,1,W]
    h = a[:, 0] * cache["h"].to(torch.float32) + b[:, 0]  # [B,W]
    y = h[:, None].to(x.dtype) * yb
    out = _out(params, y, split)
    cache["h"].copy_(h)
    cache["conv"].copy_(win[:, 1:])
    return out, cache
