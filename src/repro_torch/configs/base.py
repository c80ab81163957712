"""Core configuration dataclasses for the repro framework.

``ModelConfig`` is a single frozen dataclass wide enough to describe every
assigned architecture family (dense / moe / ssm / hybrid / encoder / vlm).
Family-specific fields default to "off" values so that a config file only
states what its architecture actually uses.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    # --- identity ------------------------------------------------------
    name: str
    family: str  # "dense" | "moe" | "ssm" | "hybrid" | "encoder" | "vlm"

    # --- trunk dimensions ---------------------------------------------
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- numerics / misc ------------------------------------------------
    activation: str = "swiglu"  # swiglu|geglu|reglu|gelu|relu
    use_bias: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    max_seq_len: int = 32_768
    final_logit_softcap: float = 0.0
    tie_embeddings: bool = False
    dtype: str = "bfloat16"  # parameter / activation dtype for full-scale runs

    # --- attention pattern ----------------------------------------------
    # Cycled over layers. "global" = full causal, "local" = sliding window.
    attn_pattern: Tuple[str, ...] = ("global",)
    sliding_window: int = 0
    qk_norm: bool = False

    # --- mixture of experts ----------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden width
    num_dense_layers: int = 0  # leading dense FF layers in MoE stacks
    router_aux_coef: float = 0.001
    capacity_factor: float = 1.25

    # --- multi-head latent attention (DeepSeek) ---------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- state-space (Mamba-2 SSD) ----------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    conv_width: int = 4
    ssm_chunk: int = 256

    # --- RG-LRU hybrid (RecurrentGemma) -------------------------------------
    lru_width: int = 0
    lru_blocks: int = 16  # block-diagonal gate matrices (official RG impl)
    # Per-residual-block pattern for hybrid stacks, e.g. ("rec","rec","attn").
    block_pattern: Tuple[str, ...] = ()

    # --- modality frontend stubs ---------------------------------------------
    frontend: str = ""  # "" | "vision_stub" | "audio_stub"
    num_prefix_embeddings: int = 0  # precomputed patch/frame embeddings

    # --- multi-token prediction (DeepSeek-V3) -----------------------------
    mtp_depth: int = 0

    # --- GRIFFIN -----------------------------------------------------------
    griffin: bool = True  # whether the technique applies to this family
    griffin_moe_experts: bool = False  # apply inside routed experts too

    # --- distributed MoE routing --------------------------------------------
    # >0: group-limited routing (DeepSeek-V3's node-limited routing taken
    # to mesh-row granularity): tokens route only within the expert group
    # of their data shard — eliminates cross-row token exchange entirely.
    moe_group_limit: int = 0

    # beyond-paper: int8 KV cache (halves decode cache reads; see
    # models/layers/attention.py)
    kv_cache_int8: bool = False

    # --- mtp / misc ---------------------------------------------------------
    remat: bool = True

    # ------------------------------------------------------------------
    # Derived helpers
    # ------------------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    @property
    def is_causal(self) -> bool:
        return self.family != "encoder"

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner_ssm // self.ssm_head_dim if self.ssm_head_dim else 0

    @property
    def has_ffn(self) -> bool:
        return self.d_ff > 0 or self.moe_d_ff > 0

    @property
    def glu(self) -> bool:
        return self.activation in ("swiglu", "geglu", "reglu")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter accounting (used for MODEL_FLOPS = 6*N*D) -------------
    def param_counts(self) -> dict:
        """Analytic parameter counts: total and active-per-token."""
        D, H, KV, hd = self.d_model, self.num_heads, self.num_kv_heads, self.head_dim
        L, V = self.num_layers, self.vocab_size
        embed = V * D
        head = 0 if self.tie_embeddings else V * D

        def attn_params() -> int:
            if self.use_mla:
                qk_head = self.qk_nope_head_dim + self.qk_rope_head_dim
                p = 0
                if self.q_lora_rank:
                    p += D * self.q_lora_rank + self.q_lora_rank * H * qk_head
                else:
                    p += D * H * qk_head
                p += D * (self.kv_lora_rank + self.qk_rope_head_dim)
                p += self.kv_lora_rank * H * (self.qk_nope_head_dim + self.v_head_dim)
                p += H * self.v_head_dim * D
                return p
            return D * H * hd + 2 * D * KV * hd + H * hd * D

        def glu_mult() -> int:
            return 3 if self.glu else 2

        total = embed + head
        active = embed // max(V, 1) * D * 0  # embedding lookup ~ 1 row; ignore
        active_layers = 0
        for li in range(L):
            lp = 0
            la = 0
            kind = self.layer_mixer_kind(li)
            if kind == "attn":
                a = attn_params()
                lp += a
                la += a
            elif kind == "ssm":
                d_in = self.d_inner_ssm
                nh = self.ssm_nheads
                # in_proj: z, x, B, C, dt
                conv_dim = d_in + 2 * self.ssm_ngroups * self.ssm_state
                lp_ssm = D * (2 * d_in + 2 * self.ssm_ngroups * self.ssm_state + nh)
                lp_ssm += conv_dim * self.conv_width
                lp_ssm += d_in * D  # out proj
                lp += lp_ssm
                la += lp_ssm
            elif kind == "rec":
                w = self.lru_width
                lp_rec = D * w * 2 + w * D + 2 * w * w // 1 * 0  # proj in(x2), out
                lp_rec += 2 * w  # a / input gate diag params (approx; depthwise)
                lp_rec += w * self.conv_width
                lp_rec += 2 * w * w  # input & recurrent gates (dense per-channel blocks)
                lp += lp_rec
                la += lp_rec
            # FFN part
            if self.num_experts and li >= self.num_dense_layers:
                e_p = self.num_experts * glu_mult() * D * self.moe_d_ff
                s_p = self.num_shared_experts * glu_mult() * D * self.moe_d_ff
                r_p = D * self.num_experts
                lp += e_p + s_p + r_p
                la += (
                    self.experts_per_token * glu_mult() * D * self.moe_d_ff
                    + s_p
                    + r_p
                )
            elif self.d_ff:
                f = glu_mult() * D * self.d_ff
                lp += f
                la += f
            total += lp
            active_layers += la
        active = embed // max(V, 1) + active_layers + head
        return {"total": total, "active": active + embed // max(V, 1)}

    def layer_mixer_kind(self, li: int) -> str:
        """Sequence-mixer kind for layer ``li``."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid" and self.block_pattern:
            return (
                "attn"
                if self.block_pattern[li % len(self.block_pattern)] == "attn"
                else "rec"
            )
        return "attn"

    def attn_kind(self, li: int) -> str:
        return self.attn_pattern[li % len(self.attn_pattern)]


def reduce_for_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Produce a tiny same-family config for CPU smoke tests."""
    period = max(len(cfg.attn_pattern), len(cfg.block_pattern) or 1)
    n_layers = max(2, period) if period > 1 else 2
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=n_layers,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 2,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        max_seq_len=256,
        dtype="float32",
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        remat=False,
    )
    if cfg.num_kv_heads == cfg.num_heads:
        kw["num_kv_heads"] = 4
    if cfg.num_kv_heads == 1:
        kw["num_kv_heads"] = 1
    if cfg.num_experts:
        kw.update(num_experts=8, experts_per_token=2, moe_d_ff=32,
                  num_shared_experts=min(cfg.num_shared_experts, 1),
                  num_dense_layers=min(cfg.num_dense_layers, 1))
    if cfg.use_mla:
        kw.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32, d_ff=0,
                  num_heads=0, num_kv_heads=0, head_dim=0)
    if cfg.lru_width:
        kw.update(lru_width=64)
    if cfg.num_prefix_embeddings:
        kw.update(num_prefix_embeddings=8)
    if cfg.mtp_depth:
        kw.update(mtp_depth=1)
    kw.update(overrides)
    return cfg.replace(**kw)
