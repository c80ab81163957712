"""DeepSeek-V3-671B: MLA attention + MoE (1 shared + 256 routed, top-8) + MTP.
[arXiv:2412.19437]

GRIFFIN applies to the shared expert and leading dense layers; routed
experts are already adaptively sparse.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,  # MLA: per-assignment GQA annotation; heads share latent
        head_dim=128,
        d_ff=18432,  # dense-layer FF width (first 3 layers)
        vocab_size=129_280,
        activation="swiglu",
        num_experts=256,
        experts_per_token=8,
        num_shared_experts=1,
        moe_d_ff=2048,
        num_dense_layers=3,
        use_mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        mtp_depth=1,
        rope_theta=10_000.0,
        max_seq_len=131_072,
        griffin=True,  # shared expert + dense layers
    )
