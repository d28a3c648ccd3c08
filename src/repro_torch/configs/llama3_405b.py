"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 — GQA, 128k vocab [arXiv:2407.21783].

The largest assigned arch: Adafactor, 8 microbatches, sequence-sharded
activations; see EXPERIMENTS.md §Dry-run for the per-device memory budget.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500_000.0,
    optimizer="adafactor",
    num_microbatches=8,
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
        dtype="float32",
        attn_chunk=16,
        remat="none",
        num_microbatches=1,
        seq_shard_activations=False,
    )
