"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn+mamba heads [arXiv:2411.13676].

Notes: 25 heads / 5 KV heads do not divide the 16-way TP axis; attention
projections stay 2-D (D, H*hd) so the flattened head axis (1600) shards.
Hymba's meta-tokens are omitted (backbone-only per assignment); the
attention branch uses a 2048-token sliding window (hybrid family ->
long_500k eligible regardless). d_inner = 2*1600 = 3200 (16 | 3200).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    hybrid=True,
    ssm_state=16,
    sliding_window=2048,
    norm="rmsnorm",
    act="silu",
    shard_heads=False,  # 25 heads don't divide TP=16 (see ModelConfig)
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=64,
        num_heads=5,
        num_kv_heads=5,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        sliding_window=16,
        ssm_state=4,
        ssm_conv=4,
        dtype="float32",
        attn_chunk=16,
        remat="none",
    )
