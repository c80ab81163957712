"""Command-R-Plus-104B: large dense GQA transformer, no biases.
[hf:CohereForAI/c4ai-command-r-plus]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b",
        family="dense",
        num_layers=64,
        d_model=12288,
        num_heads=96,
        num_kv_heads=8,
        head_dim=128,
        d_ff=33792,
        vocab_size=256_000,
        activation="swiglu",
        use_bias=False,
        rope_theta=75_000_000.0,
        max_seq_len=131_072,
        tie_embeddings=True,
        griffin=True,
    )
