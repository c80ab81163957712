"""Mamba2-1.3B: attention-free SSM (state-space duality / SSD).
[arXiv:2405.21060]

No FF blocks (d_ff=0): GRIFFIN is inapplicable to this family -- the arch
is implemented without the technique (see DESIGN.md section 4).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50280,
        activation="gelu",
        norm="rmsnorm",
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_ngroups=1,
        conv_width=4,
        ssm_chunk=256,
        max_seq_len=1_048_576,
        griffin=False,  # no FF block to prune
    )
