"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution [arXiv:2409.12191].

Backbone only per assignment: the vision frontend is a stub —
``input_specs()`` provides precomputed patch embeddings (B, S, D) plus
(3, B, S) M-RoPE position ids for train/prefill; decode embeds generated
text tokens through the vocab table.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    mrope=True,
    mrope_sections=(16, 24, 24),
    embed_input=False,
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
        mrope_sections=(2, 3, 3),
        d_ff=128,
        vocab_size=256,
        dtype="float32",
        attn_chunk=16,
        remat="none",
        num_microbatches=1,
        seq_shard_activations=False,
    )
