"""olmo-1b [dense]: 16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304
— non-parametric LayerNorm [arXiv:2402.00838]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparametric",
    act="silu",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        dtype="float32",
        attn_chunk=16,
        remat="none",
    )
