"""Architecture registry of the port: ``get_config(name)`` /
``list_archs()`` over the configurations this slice serves."""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.configs import (
    deepseek_v3_671b,
    moonshot_v1_16b_a3b,
    smollm_360m,
    tinylm,
    yi_9b,
)
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {
    "yi-9b": yi_9b.config,
    "smollm-360m": smollm_360m.config,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b.config,
    "deepseek-v3-671b": deepseek_v3_671b.config,
    "tinylm": tinylm.config,
    "tinylm-tp": tinylm.config_tp,
    "lm100m": tinylm.config_100m,
}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    return reduce_for_smoke(cfg) if smoke else cfg


def list_archs() -> list[str]:
    return list(_REGISTRY)
