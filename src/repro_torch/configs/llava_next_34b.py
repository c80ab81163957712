"""LLaVA-NeXT-34B: VLM with a Yi-34B-like dense LM backbone; anyres vision
tiling.  [hf:llava-hf/llava-v1.6-34b-hf]

Per assignment, only the transformer BACKBONE is modeled; the vision
frontend is a stub (``input_specs`` provides precomputed patch embeddings
prepended to the token embeddings).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        family="vlm",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64000,
        activation="swiglu",
        rope_theta=5_000_000.0,
        max_seq_len=131_072,
        frontend="vision_stub",
        num_prefix_embeddings=2880,  # anyres: base 576 + 4 tiles x 576
        griffin=True,
    )
