from repro_torch.configs.base import ModelConfig, reduce_for_smoke

__all__ = ["ModelConfig", "reduce_for_smoke"]
