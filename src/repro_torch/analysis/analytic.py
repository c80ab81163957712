"""Analytic per-cell FLOPs / HBM-byte models (port of
``repro/analysis/analytic.py``; the arithmetic is the reference's, term
for term, so ``cell_cost`` equals it for every cell).

The reference derives the matmul-level FLOPs and the unavoidable HBM
traffic per (arch x shape x phase) analytically because XLA's
``cost_analysis()`` is unreliable on its CPU backend; the port has no
compiled artifact at all, so these are the roofline's FLOPs and bytes
(``launch.dryrun``), on the card's rates (``summarize``).

All numbers are GLOBAL (whole cluster); divide by chips for per-chip
terms under balanced sharding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig


def _glu_mult(cfg) -> int:
    return 3 if cfg.glu else 2


def _dtype_bytes(cfg) -> int:
    return 2 if cfg.dtype in ("bfloat16", "float16") else 4


@dataclass
class CellCost:
    flops: float  # global matmul(+recurrence) flops
    param_bytes: float  # parameter bytes read once
    cache_bytes: float  # KV/state bytes read (+written) per step
    act_bytes: float  # major activation traffic (approx)

    @property
    def hbm_bytes(self) -> float:
        return self.param_bytes + self.cache_bytes + self.act_bytes


def _attn_layer_flops(cfg, B, S_q, S_kv, window=0, causal=True) -> float:
    """Projections + scores + PV for one attention layer (global)."""
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.use_mla:
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        r = cfg.kv_lora_rank
        proj = 0.0
        if cfg.q_lora_rank:
            proj += 2 * B * S_q * (D * cfg.q_lora_rank + cfg.q_lora_rank * H * (dn + dr))
        else:
            proj += 2 * B * S_q * D * H * (dn + dr)
        proj += 2 * B * S_q * D * (r + dr)  # kv compression
        if S_q > 1:  # expanded form (prefill/train)
            proj += 2 * B * S_kv * r * H * (dn + dv)  # k_nope + v expansion
            qk_hd, pv_hd = dn + dr, dv
        else:  # absorbed decode
            proj += 2 * B * H * dn * r  # q absorption
            proj += 2 * B * H * r * dv  # context expansion
            qk_hd, pv_hd = r + dr, r
        proj += 2 * B * S_q * H * dv * D  # out proj
        eff = _attn_scores_flops(B, H, S_q, S_kv, qk_hd, pv_hd, window, causal)
        return proj + eff
    proj = 2 * B * S_q * D * (H * hd + 2 * KV * hd) + 2 * B * S_q * H * hd * D
    eff = _attn_scores_flops(B, H, S_q, S_kv, hd, hd, window, causal)
    return proj + eff


def _attn_scores_flops(B, H, S_q, S_kv, qk_hd, pv_hd, window, causal) -> float:
    if S_q == 1:
        n_k = min(S_kv, window) if window else S_kv
        return 2 * B * H * n_k * (qk_hd + pv_hd)
    if window:
        n_pairs = S_q * min(window, S_kv)
    elif causal:
        n_pairs = S_q * S_kv / 2
    else:
        n_pairs = S_q * S_kv
    return 2 * B * H * n_pairs * (qk_hd + pv_hd)


def _ffn_layer_flops(cfg, B, S, d_ff, pruned_frac=1.0) -> float:
    return 2 * B * S * cfg.d_model * d_ff * _glu_mult(cfg) * pruned_frac


def _moe_layer_flops(cfg, B, S) -> float:
    """Routed experts (active-only, incl. capacity padding) + shared."""
    f = 2 * B * S * cfg.d_model * cfg.moe_d_ff * _glu_mult(cfg)
    routed = f * cfg.experts_per_token * cfg.capacity_factor
    shared = f * cfg.num_shared_experts
    router = 2 * B * S * cfg.d_model * cfg.num_experts
    return routed + shared + router


def _ssm_layer_flops(cfg, B, S) -> float:
    D = cfg.d_model
    d_in = cfg.d_inner_ssm
    H, P, N, G = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_ngroups
    proj = 2 * B * S * D * (2 * d_in + 2 * G * N + H) + 2 * B * S * d_in * D
    if S == 1:
        ssd = 2 * B * H * P * N * 2  # state update + output
    else:
        Q = min(cfg.ssm_chunk, S)
        nc = max(S // Q, 1)
        intra = 2 * B * nc * H * Q * Q * (N + P)  # scores + Y_diag
        states = 2 * B * nc * H * Q * P * N * 2  # chunk states + Y_off
        ssd = intra + states
    return proj + ssd


def _rglru_layer_flops(cfg, B, S) -> float:
    D, W = cfg.d_model, cfg.lru_width
    nb = min(getattr(cfg, "lru_blocks", 16), W)
    proj = 2 * B * S * D * W * 2 + 2 * B * S * W * D
    gates = 2 * B * S * W * (W // nb) * 2  # block-diagonal
    rec = B * S * W * 8  # elementwise recurrence
    return proj + gates + rec


def _head_flops(cfg, B, S) -> float:
    return 2 * B * S * cfg.d_model * cfg.vocab_size


def _layer_flops(cfg, li, B, S_q, S_kv, griffin_frac=1.0) -> float:
    kind = cfg.layer_mixer_kind(li)
    total = 0.0
    if kind == "attn":
        window = cfg.sliding_window if cfg.attn_kind(li) == "local" else 0
        total += _attn_layer_flops(cfg, B, S_q, S_kv, window, cfg.is_causal)
    elif kind == "ssm":
        total += _ssm_layer_flops(cfg, B, S_q)
    else:
        total += _rglru_layer_flops(cfg, B, S_q)
    if cfg.num_experts and li >= cfg.num_dense_layers:
        f = 2 * B * S_q * cfg.d_model * cfg.moe_d_ff * _glu_mult(cfg)
        routed = f * cfg.experts_per_token * cfg.capacity_factor
        shared = f * cfg.num_shared_experts * griffin_frac
        router = 2 * B * S_q * cfg.d_model * cfg.num_experts
        total += routed + shared + router
    elif cfg.d_ff:
        total += _ffn_layer_flops(cfg, B, S_q, cfg.d_ff, griffin_frac)
    return total


def _param_bytes(cfg) -> float:
    from repro_torch.analysis.roofline import count_params

    return count_params(cfg)["total"] * _dtype_bytes(cfg)


def _active_param_bytes(cfg, griffin_frac=1.0) -> float:
    """Bytes of parameters actually read in one decode step."""
    from repro_torch.analysis.roofline import count_params

    active = count_params(cfg)["active"]
    if griffin_frac < 1.0:
        glu = _glu_mult(cfg)
        ff = 0
        for li in range(cfg.num_layers):
            if cfg.num_experts and li >= cfg.num_dense_layers:
                ff += glu * cfg.d_model * cfg.moe_d_ff * cfg.num_shared_experts
            elif cfg.d_ff:
                ff += glu * cfg.d_model * cfg.d_ff
        active = active - ff * (1.0 - griffin_frac)
    return active * _dtype_bytes(cfg)


def _cache_bytes(cfg, B, S) -> float:
    """Decode-phase cache read bytes per step (+ write is negligible)."""
    dt = _dtype_bytes(cfg)
    total = 0.0
    for li in range(cfg.num_layers):
        kind = cfg.layer_mixer_kind(li)
        if kind == "attn":
            if cfg.use_mla:
                per_tok = cfg.kv_lora_rank + cfg.qk_rope_head_dim
            else:
                per_tok = 2 * cfg.num_kv_heads * cfg.head_dim
            n = min(S, cfg.sliding_window) if (
                cfg.attn_kind(li) == "local" and cfg.sliding_window
            ) else S
            total += B * n * per_tok * dt
        elif kind == "ssm":
            total += B * cfg.ssm_nheads * cfg.ssm_head_dim * cfg.ssm_state * 4
        else:
            total += B * cfg.lru_width * 4
    return total


def cell_cost(cfg: ModelConfig, shape: ShapeConfig, *,
              griffin_sparsity: float = 0.0) -> CellCost:
    """Analytic global cost of one step of this cell.

    griffin_sparsity > 0 applies to decode cells only (the paper's
    generation phase); train/prefill always run the full FF blocks.
    """
    B, S = shape.global_batch, shape.seq_len
    dt = _dtype_bytes(cfg)

    if shape.kind == "decode":
        frac = 1.0 - griffin_sparsity
        flops = sum(_layer_flops(cfg, li, B, 1, S, frac)
                    for li in range(cfg.num_layers))
        flops += _head_flops(cfg, B, 1)
        return CellCost(
            flops=flops,
            param_bytes=_active_param_bytes(cfg, frac),
            cache_bytes=_cache_bytes(cfg, B, S),
            act_bytes=B * cfg.d_model * dt * 4 * cfg.num_layers,
        )

    # train / prefill: full sequence
    flops = sum(_layer_flops(cfg, li, B, S, S) for li in range(cfg.num_layers))
    flops += _head_flops(cfg, B, S)
    if shape.kind == "train":
        flops *= 3  # fwd + bwd(2x)
        if cfg.remat:
            flops *= 4 / 3  # nothing_saveable recompute ~ one extra fwd
        if cfg.mtp_depth:
            flops *= 1.0 + 1.5 / cfg.num_layers  # MTP extra block
    act = B * S * cfg.d_model * dt * 8 * cfg.num_layers
    return CellCost(
        flops=flops,
        param_bytes=_param_bytes(cfg) * (3 if shape.kind == "train" else 1),
        cache_bytes=0.0,
        act_bytes=act,
    )


def summarize(cfg, shape, chips: int, griffin_sparsity: float = 0.0) -> Dict:
    """The cell's analytic totals and their terms per card on the card's
    rates (``roofline``; the peak for ``cfg.dtype``)."""
    from repro_torch.analysis.roofline import HBM_BW, model_flops, peak_flops

    c = cell_cost(cfg, shape, griffin_sparsity=griffin_sparsity)
    mf = model_flops(cfg, shape)
    return {
        "analytic_flops_total": c.flops,
        "analytic_hbm_bytes_total": c.hbm_bytes,
        "analytic_compute_s": c.flops / chips / peak_flops(cfg.dtype),
        "analytic_memory_s": c.hbm_bytes / chips / HBM_BW,
        "model_flops_total": mf,
    }
