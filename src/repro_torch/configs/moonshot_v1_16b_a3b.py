"""Moonlight-16B-A3B (moonshot-v1-16b-a3b): MoE, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B]

GRIFFIN applies to the shared expert / dense layers; routed experts are
already adaptively sparse (flag ``griffin_moe_experts`` enables in-expert
block pruning as a beyond-paper experiment).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=11264,  # dense-layer FF width (first dense layer)
        vocab_size=163_840,
        activation="swiglu",
        num_experts=64,
        experts_per_token=6,
        num_shared_experts=2,
        moe_d_ff=1408,
        num_dense_layers=1,
        rope_theta=50_000.0,
        max_seq_len=131_072,
        griffin=True,  # shared experts + dense layers
    )
