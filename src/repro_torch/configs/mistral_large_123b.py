"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768 [hf:mistralai/Mistral-Large-Instruct-2407]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
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
        dtype="float32",
        attn_chunk=16,
        remat="none",
        num_microbatches=1,
        seq_shard_activations=False,
    )
