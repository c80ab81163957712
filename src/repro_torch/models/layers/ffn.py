"""Feed-forward blocks with GRIFFIN instrumentation (port of
``repro/models/layers/ffn.py``, the parts the serving path uses).

    FF(x)  = FF2(FF1(x)),      z = FF1(x)            (eq. 1)
    FF1(x) = sigma(W_g x) * (W_1 x)                   (GLU, eq. 3)
    FF1(x) = sigma(W_1 x)                             (non-GLU, eq. 2)

``griffin_stat_sq`` is the per-sample squared GRIFFIN statistic (eq. 6,
the ``expert_stat`` kernel on the card), ``ffn_forward`` the dense block
with the statistics on request; ``compact_ffn_params`` is the
paper's reparameterization: keep the expert neurons' columns of W_g/W_1
and rows of W_2.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import activation_fn
from repro_torch.models.param import ParamSpec


def ffn_specs(cfg, d_ff: Optional[int] = None, glu: Optional[bool] = None) -> Dict[str, ParamSpec]:
    D = cfg.d_model
    Fw = d_ff if d_ff is not None else cfg.d_ff
    g = cfg.glu if glu is None else glu
    specs = {
        "w1": ParamSpec((D, Fw), ("embed", "mlp")),
        "w2": ParamSpec((Fw, D), ("mlp", "embed")),
    }
    if g:
        specs["wg"] = ParamSpec((D, Fw), ("embed", "mlp"))
    if cfg.use_bias:
        specs["b1"] = ParamSpec((Fw,), ("mlp",), init="zeros")
        specs["b2"] = ParamSpec((D,), ("act_embed",), init="zeros")
        if g:
            specs["bg"] = ParamSpec((Fw,), ("mlp",), init="zeros")
    return specs


def ffn_activations(params: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """z = FF1(x).  x: [..., D] -> z: [..., F]."""
    act = activation_fn(cfg.activation)
    h1 = x @ params["w1"]
    if "b1" in params:
        h1 = h1 + params["b1"]
    if "wg" in params:
        hg = x @ params["wg"]
        if "bg" in params:
            hg = hg + params["bg"]
        return act(hg) * h1
    return act(h1)


def griffin_stat_sq(z: torch.Tensor) -> torch.Tensor:
    """Per-sample squared statistic from activations z [B,S,F] (eq. 6):
    ``s_sq[b, j] = sum_t z[b,t,j]^2 / ||z[b,t]||^2`` in fp32 -> [B, F].
    On the card this launches the ``expert_stat`` kernel."""
    return ops.griffin_stat(z)


def ffn_forward(params: Dict, x: torch.Tensor, cfg, collect_stats: bool = False
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: [B,S,D] -> (y [B,S,D], stats or None).

    stats = {s_sq [B,F]}, the GRIFFIN statistic (eq. 6)."""
    z = ffn_activations(params, x, cfg)
    stats = {"s_sq": griffin_stat_sq(z)} if collect_stats else None
    y = z @ params["w2"]
    if "b2" in params:
        y = y + params["b2"]
    return y, stats


def ffn_forward_perslot(params: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """FF forward with *per-request* weights (leading slot axis).

    The paged serving path keeps one GRIFFIN-compacted FF block per
    decode slot: leaves are [B, D, k] / [B, k, D], x is [B, S, D]."""
    act = activation_fn(cfg.activation)
    h1 = torch.bmm(x, params["w1"])
    if "b1" in params:
        h1 = h1 + params["b1"][:, None]
    if "wg" in params:
        hg = torch.bmm(x, params["wg"])
        if "bg" in params:
            hg = hg + params["bg"][:, None]
        z = act(hg) * h1
    else:
        z = act(h1)
    y = torch.bmm(z, params["w2"])
    if "b2" in params:
        y = y + params["b2"][:, None]
    return y


def compact_ffn_params(params: Dict, idx: torch.Tensor, shards: int = 1) -> Dict:
    """GRIFFIN reparameterization (section 4.2): gather expert neurons E.

    idx: [k] neuron indices (sorted).  Returns a k-wide FF block.  With
    ``shards > 1`` (per-shard balanced selection) every contiguous
    ``F/shards`` range holds exactly ``k/shards`` indices, so the plain
    gather below already keeps each shard's experts in its own block."""
    idx = idx.to(device=params["w1"].device, dtype=torch.long)
    out = {
        "w1": params["w1"].index_select(1, idx),
        "w2": params["w2"].index_select(0, idx),
    }
    if "wg" in params:
        out["wg"] = params["wg"].index_select(1, idx)
    if "b1" in params:
        out["b1"] = params["b1"].index_select(0, idx)
    if "bg" in params:
        out["bg"] = params["bg"].index_select(0, idx)
    if "b2" in params:
        out["b2"] = params["b2"]
    return out


# expert-axis position per compacted-FF leaf (negative: leaves may carry
# a leading slot axis); b2 has no expert axis
_EXPERT_AXIS = {"w1": -1, "wg": -1, "w2": -2, "b1": -1, "bg": -1}


def pad_compacted(params: Dict, k_pad: int, shards: int = 1) -> Dict:
    """Zero-pad a compacted FF block's expert axis from ``k`` to ``k_pad``
    (mixed-tier ticks bucket every request's buffers to one width).

    Zero ``w2`` rows make the padded experts contribute exactly ``0.0``.
    ``shards > 1`` pads each contiguous shard block at its own tail."""
    k = params["w2"].shape[-2]
    if k_pad == k:
        return dict(params)
    if k_pad < k:
        raise ValueError(f"pad_compacted: k_pad {k_pad} < k {k}")
    if shards > 1 and (k % shards or k_pad % shards):
        raise ValueError(
            f"pad_compacted: per-shard padding needs k ({k}) and k_pad "
            f"({k_pad}) divisible by shards ({shards})"
        )

    def pad(v: torch.Tensor, ax: int) -> torch.Tensor:
        ax = v.ndim + ax
        if shards == 1:
            widths = [0, 0] * (v.ndim - 1 - ax) + [0, k_pad - k]
            return F.pad(v, widths)
        shape = v.shape[:ax] + (shards, k // shards) + v.shape[ax + 1:]
        widths = [0, 0] * (v.ndim - 1 - ax) + [0, (k_pad - k) // shards]
        out = F.pad(v.reshape(shape), widths)
        return out.reshape(v.shape[:ax] + (k_pad,) + v.shape[ax + 1:])

    return {
        name: pad(v, _EXPERT_AXIS[name]) if name in _EXPERT_AXIS else v
        for name, v in params.items()
    }


def pruned_specs(cfg, k: int) -> Dict[str, ParamSpec]:
    """Specs of the compacted decode-phase FF block."""
    return ffn_specs(cfg, d_ff=k)
