"""Assigned input-shape registry.

Every (architecture x shape) cell is well-defined through
``cell_supported`` which encodes the assignment's skip rules:
  * ``long_500k`` needs sub-quadratic attention -> only ssm / hybrid
    (mamba2, recurrentgemma, gemma3's 5:1 local:global stack qualifies).
  * encoder-only archs have no decode step -> skip decode shapes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# Architectures whose attention stack is sub-quadratic enough for 500k
# decode: attention-free (ssm), RG-LRU+local hybrid, and gemma3 whose
# global layers are 1-in-6 (decode cost O(S) per step, cache shardable).
_SUBQUADRATIC = {"mamba2-1.3b", "recurrentgemma-9b", "gemma3-27b"}


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell, with skip rationale."""
    if cfg.family == "encoder" and shape.kind == "decode":
        return False, "encoder-only arch: no autoregressive decode step"
    if shape.name == "long_500k" and cfg.name not in _SUBQUADRATIC:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.name} is pure full-attention"
        )
    return True, ""


def smoke_shape(shape: ShapeConfig) -> ShapeConfig:
    """Reduced shape for CPU smoke testing."""
    return ShapeConfig(shape.name + "-smoke", seq_len=min(shape.seq_len, 64),
                       global_batch=min(shape.global_batch, 2), kind=shape.kind)
