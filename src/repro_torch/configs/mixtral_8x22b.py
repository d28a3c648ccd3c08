"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA [arXiv:2401.04088].

Adafactor + microbatching keep single-pod (256-chip) training in HBM.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    optimizer="adafactor",
    num_microbatches=4,
    seq_shard_activations=True,
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
        num_experts=4,
        capacity_factor=4.0,
        sliding_window=16,
        dtype="float32",
        attn_chunk=16,
        remat="none",
        num_microbatches=1,
        seq_shard_activations=False,
    )
