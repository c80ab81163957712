"""Architecture registry of the port: ``get_config(name)`` /
``list_archs()``, the reference's archs in the reference's order."""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.configs import (
    command_r_plus_104b,
    deepseek_v3_671b,
    gemma3_27b,
    hubert_xlarge,
    llava_next_34b,
    mamba2_1_3b,
    moonshot_v1_16b_a3b,
    recurrentgemma_9b,
    smollm_360m,
    tinylm,
    yi_9b,
)
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {
    "yi-9b": yi_9b.config,
    "gemma3-27b": gemma3_27b.config,
    "smollm-360m": smollm_360m.config,
    "command-r-plus-104b": command_r_plus_104b.config,
    "mamba2-1.3b": mamba2_1_3b.config,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b.config,
    "deepseek-v3-671b": deepseek_v3_671b.config,
    "llava-next-34b": llava_next_34b.config,
    "recurrentgemma-9b": recurrentgemma_9b.config,
    "hubert-xlarge": hubert_xlarge.config,
    # local (non-assigned) configs for training examples / benchmarks
    "tinylm": tinylm.config,
    "tinylm-tp": tinylm.config_tp,
    "lm100m": tinylm.config_100m,
}

ASSIGNED_ARCHS = [
    "yi-9b",
    "gemma3-27b",
    "smollm-360m",
    "command-r-plus-104b",
    "mamba2-1.3b",
    "moonshot-v1-16b-a3b",
    "deepseek-v3-671b",
    "llava-next-34b",
    "recurrentgemma-9b",
    "hubert-xlarge",
]


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    return reduce_for_smoke(cfg) if smoke else cfg


def list_archs() -> list[str]:
    return list(_REGISTRY)
