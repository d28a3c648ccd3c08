"""whisper-tiny [audio]: 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865 —
encoder-decoder, conv frontend stub [arXiv:2212.04356].

The audio frontend is a stub per assignment: ``input_specs()`` provides
precomputed frame embeddings (B, S_enc, 384). prefill_* cells run the
encoder over S_enc frames + the decoder prompt; decode cells step the
decoder self-attention cache and cross-attend to ``encoder_len`` frames.
Absolute (sinusoidal/learned) positions; LayerNorm; GELU MLP; no RoPE.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    num_encoder_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    norm="layernorm",
    act="gelu",
    encoder_decoder=True,
    cross_attention=True,
    encoder_len=1500,
    shard_heads=False,  # 6 heads don't divide TP=16 (see ModelConfig)
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        num_encoder_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        encoder_len=32,
        dtype="float32",
        attn_chunk=16,
        remat="none",
    )
