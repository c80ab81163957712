"""SmolLM-360M: small llama-arch dense transformer with GQA.
[hf:HuggingFaceTB/SmolLM-360M]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m",
        family="dense",
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        head_dim=64,
        d_ff=2560,
        vocab_size=49152,
        activation="swiglu",
        tie_embeddings=True,
        rope_theta=10_000.0,
        max_seq_len=32_768,
        griffin=True,
    )
