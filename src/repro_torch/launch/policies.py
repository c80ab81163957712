"""Per-(arch x shape) distribution policies for the production meshes
(port of ``repro/launch/policies.py``).

Encodes the decisions documented in DESIGN.md section 6:
  * FSDP (weight embed-axis over ``data``) for >=9B param archs,
  * expert 2D sharding for deepseek (256 experts == 16x16),
  * optimizer choice (adam8bit where fp32 Adam state cannot fit v5e),
  * gradient-accumulation depth (activation-memory lever),
  * GRIFFIN defaults (50% FF sparsity, per-shard balanced top-k).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.griffin import GriffinConfig
from repro_torch.distributed.sharding import Rules, make_rules

# rough total-param scale per arch (drives FSDP / optimizer choices)
_BIG = {"command-r-plus-104b", "deepseek-v3-671b"}
_MID = {
    "yi-9b",
    "gemma3-27b",
    "llava-next-34b",
    "recurrentgemma-9b",
    "moonshot-v1-16b-a3b",
}


@dataclass(frozen=True)
class CellPolicy:
    rules: Rules
    optimizer: str = "adamw"
    accum_steps: int = 1
    griffin: Optional[GriffinConfig] = None
    q_chunk: int = 1024
    moe_chunk_tokens: int = 16_384


def policy_for(cfg: ModelConfig, shape: ShapeConfig, *,
               seq_parallel: bool = False,
               optimizer: Optional[str] = None,
               fsdp: Optional[bool] = None,
               griffin_sparsity: float = 0.5,
               use_griffin: bool = True) -> CellPolicy:
    big = cfg.name in _BIG
    mid = cfg.name in _MID
    expert_2d = cfg.name == "deepseek-v3-671b"
    phase = "train" if shape.kind == "train" else "serve"

    if fsdp is None:
        fsdp = big or (mid and phase == "train") or (big and phase == "serve")
    # shard cache seq over model when kv-heads can't occupy the model axis
    # (GQA with few kv heads, MLA's headless latent cache)
    kv_seq_model = cfg.use_mla or not (
        cfg.num_kv_heads and cfg.num_kv_heads % 16 == 0
    )
    # decode: shard head_dim when head counts can't use the model axis
    head_dim_fallback = (
        shape.kind == "decode"
        and cfg.num_heads > 0
        and (cfg.num_heads % 16 != 0 or cfg.num_kv_heads % 16 != 0)
    )
    # llava prefill with unpadded heads: attention weights would replicate
    # (56 heads); weight-gather (fsdp) keeps it under the HBM budget.
    # (The preferred fix is head padding — see pad_attention_heads.)
    if (cfg.name == "llava-next-34b" and shape.kind == "prefill"
            and cfg.num_heads % 16 != 0):
        fsdp = True
    rules = make_rules(
        phase=phase, fsdp=fsdp, seq_parallel=seq_parallel, expert_2d=expert_2d,
        kv_seq_model=kv_seq_model, head_dim_fallback=head_dim_fallback,
    )

    if optimizer is None:
        optimizer = "adam8bit" if cfg.name == "deepseek-v3-671b" else "adamw"

    accum = 1
    if shape.kind == "train":
        if big:
            accum = 16
        elif mid:
            accum = 8

    gcfg = None
    if use_griffin and cfg.griffin and cfg.has_ffn and shape.kind != "train":
        # per_shard_topk inherits griffin.DEFAULT_PER_SHARD_TOPK (the
        # single source launch/serve.py also uses) — balanced shard-local
        # selection is required under tp_shards anyway
        gcfg = GriffinConfig(sparsity=griffin_sparsity, tp_shards=16)

    return CellPolicy(
        rules=rules,
        optimizer=optimizer,
        accum_steps=accum,
        griffin=gcfg,
        q_chunk=1024,
    )
