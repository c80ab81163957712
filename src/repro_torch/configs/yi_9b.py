"""Yi-9B: llama-arch dense transformer with GQA. [arXiv:2403.04652]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b",
        family="dense",
        num_layers=48,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab_size=64000,
        activation="swiglu",
        rope_theta=10_000.0,
        max_seq_len=524_288,
        griffin=True,
    )
