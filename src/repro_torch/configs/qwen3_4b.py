"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) head_dim=128 (explicit)
d_ff=9728 vocab=151936 — qk_norm, tied embeddings [hf:Qwen/Qwen3-4B]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        dtype="float32",
        attn_chunk=16,
        remat="none",
    )
