"""Small trainable LMs used by the end-to-end examples and quality
benchmarks (the container is CPU-only; these stand in for the paper's
Llama-2/Gemma evaluations at mechanism scale).

``tinylm``    ~2.8M params  -- trains to a usable char-LM in minutes on CPU.
``tinylm-tp`` same scale    -- head/FF counts divisible by small tensor-
                              parallel meshes (tinylm's 3 KV heads are
                              not), for the sharded-serving identity
                              tests and BENCH_sharded.
``lm100m``    ~103M params  -- the "train a ~100M model" driver config.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="tinylm",
        family="dense",
        num_layers=4,
        d_model=192,
        num_heads=6,
        num_kv_heads=3,
        head_dim=32,
        d_ff=512,
        vocab_size=256,  # byte-level
        activation="swiglu",
        tie_embeddings=True,
        max_seq_len=1024,
        dtype="float32",
        remat=False,
        griffin=True,
    )


def config_tp() -> ModelConfig:
    """tinylm with TP-friendly head counts: 8 query / 4 KV heads (GQA
    2:1) so a ``model`` mesh axis of 2 or 4 divides heads, KV heads and
    ``d_ff`` — the divisibility the shard_map paged serving path
    requires (``repro.distributed.tp``)."""
    return ModelConfig(
        name="tinylm-tp",
        family="dense",
        num_layers=4,
        d_model=192,
        num_heads=8,
        num_kv_heads=4,
        head_dim=24,
        d_ff=512,
        vocab_size=256,  # byte-level
        activation="swiglu",
        tie_embeddings=True,
        max_seq_len=1024,
        dtype="float32",
        remat=False,
        griffin=True,
    )


def config_100m() -> ModelConfig:
    return ModelConfig(
        name="lm100m",
        family="dense",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=4,
        head_dim=64,
        d_ff=2048,
        vocab_size=32768,
        activation="swiglu",
        tie_embeddings=True,
        max_seq_len=4096,
        dtype="float32",
        griffin=True,
    )
