"""RecurrentGemma-9B: Griffin-architecture hybrid -- RG-LRU recurrent blocks
and local (sliding-window) attention in a 2:1 pattern.  [arXiv:2402.19427]

Note the naming coincidence: DeepMind's "Griffin" architecture is unrelated
to this paper's GRIFFIN pruning method; the pruning method applies to the
GeGLU FF blocks present in every residual block here.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,  # MQA
        head_dim=256,
        d_ff=12288,
        vocab_size=256_000,
        activation="geglu",
        attn_pattern=("local",),
        block_pattern=("rec", "rec", "attn"),
        sliding_window=2048,
        lru_width=4096,
        conv_width=4,
        rope_theta=10_000.0,
        max_seq_len=524_288,  # unbounded in principle; cache is window-capped
        tie_embeddings=True,
        griffin=True,
    )
