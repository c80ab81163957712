"""Shared building blocks: norms, activations, RoPE, embeddings (port of
``repro/models/common.py``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as shlib
from repro_torch.models.param import ParamSpec


# ---------------------------------------------------------------------------
# Norms (computed in fp32, cast back)
# ---------------------------------------------------------------------------

def norm_specs(cfg, d: Optional[int] = None) -> Dict[str, ParamSpec]:
    d = d or cfg.d_model
    specs = {"scale": ParamSpec((d,), ("act_embed",), init="ones")}
    if cfg.norm == "layernorm":
        specs["bias"] = ParamSpec((d,), ("act_embed",), init="zeros")
    return specs


def apply_norm(params: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
        y = y * params["scale"].float() + params["bias"].float()
    else:  # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + 1e-6) * params["scale"].float()
    return y.to(x.dtype)


def rms_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Unit-free RMS normalization (no learned scale)."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str):
    """geglu/gelu use the tanh approximation, as the reference does."""
    return {
        "swiglu": F.silu,
        "geglu": _gelu_tanh,
        "reglu": F.relu,
        "gelu": _gelu_tanh,
        "relu": F.relu,
        "silu": F.silu,
    }[name]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, hd: int, theta: float):
    """cos/sin of the rotation angles for ``positions`` [..., S]: each
    [..., S, 1, hd/2] fp32.  Shared by every layer of a step."""
    half = hd // 2
    freq = torch.arange(half, dtype=torch.float32, device=positions.device)
    inv_freq = torch.pow(float(theta), -freq / half)  # [half]
    ang = positions.float()[..., None] * inv_freq  # [..., S, half]
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               cos_sin=None) -> torch.Tensor:
    """Rotate the two halves. x: [..., S, H, hd]; positions: [..., S].
    ``cos_sin`` (from ``rope_cos_sin``) skips recomputing the angles."""
    half = x.shape[-1] // 2
    cos, sin = cos_sin if cos_sin is not None else \
        rope_cos_sin(positions, x.shape[-1], theta)
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embed_specs(cfg) -> Dict[str, ParamSpec]:
    row_axis = "vocab" if cfg.tie_embeddings else "tok_vocab"
    return {
        "table": ParamSpec(
            (cfg.vocab_size, cfg.d_model), (row_axis, "embed"), init="embed",
            scale=cfg.d_model**-0.5 if cfg.tie_embeddings else 1.0,
        )
    }


def _vocab_offset(local: int) -> int:
    """First vocabulary row of this rank's block on the training mesh."""
    mesh, _ = shlib.active_rules()
    return mesh.coord("model") * local


def embed_lookup(params: Dict, tokens: torch.Tensor, cfg,
                 summed: bool = True) -> torch.Tensor:
    """Rows of the table for ``tokens``.  On a training mesh whose rules
    split the (tied) table's rows over ``model``, each rank looks up the
    tokens it owns, zeros elsewhere, and the rows are summed over
    ``model`` (exact: one rank contributes each row); without ``summed``
    the caller sums them (``decoder``'s sequence-parallel entry)."""
    table = params["table"]
    V = table.shape[0]
    if shlib.model_split(V, cfg.vocab_size):
        local = tokens - _vocab_offset(V)
        own = (local >= 0) & (local < V)
        x = table[local.clamp(0, V - 1)] * own[..., None].to(table.dtype)
        if summed:
            x = shlib.reduce(x, "model")
    else:
        x = table[tokens]
    # gemma-style sqrt(d) scaling keeps tied-embedding logits sane; the
    # factor is rounded to the table dtype first (on the host: a device
    # scalar would cost a sync), as in the reference
    if cfg.tie_embeddings:
        x = x * float(torch.tensor(cfg.d_model**0.5, dtype=x.dtype))
    return x


def head_specs(cfg) -> Dict[str, ParamSpec]:
    if cfg.tie_embeddings:
        return {}
    return {"w": ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))}


def lm_logits(head_params: Dict, embed_params: Dict, x: torch.Tensor,
              cfg) -> torch.Tensor:
    """fp32 logits.  On a training mesh that splits the vocabulary over
    ``model`` they are this rank's block of the vocabulary (the loss
    reduces over ``model``: ``decoder.chunked_ce``)."""
    w = embed_params["table"].T if cfg.tie_embeddings else head_params["w"]
    if shlib.model_split(w.shape[-1], cfg.vocab_size):
        x = shlib.block_in(x)
    logits = (x @ w).float()  # [..., V]
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits
