"""HuBERT-XLarge: encoder-only audio transformer (w2v2 arch), GELU FF.
[arXiv:2106.07447]

Encoder-only: no autoregressive decode phase exists, so GRIFFIN's
prompt->generation selection contract is undefined -- the arch is
implemented without the technique (flocking *analysis* remains available
on encoder FF activations).  The CNN waveform frontend is a stub;
``input_specs`` provides precomputed frame embeddings.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="encoder",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        activation="gelu",
        use_bias=True,
        norm="layernorm",
        max_seq_len=32_768,
        frontend="audio_stub",
        griffin=False,  # no generation phase
    )
