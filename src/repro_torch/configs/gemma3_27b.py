"""Gemma-3-27B: dense GeGLU transformer, 5:1 local:global attention, 128k+
context.  [hf:google/gemma-3 family]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b",
        family="dense",
        num_layers=62,
        d_model=5376,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab_size=262_144,
        activation="geglu",
        attn_pattern=("local", "local", "local", "local", "local", "global"),
        sliding_window=1024,
        qk_norm=True,
        rope_theta=1_000_000.0,
        max_seq_len=524_288,
        final_logit_softcap=0.0,
        tie_embeddings=True,
        griffin=True,
    )
