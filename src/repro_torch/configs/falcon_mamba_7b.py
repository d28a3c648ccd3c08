"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16 — mamba-1 architecture [arXiv:2410.05355].

d_ff=0 per assignment: each layer is a single mamba block (no separate MLP).
O(1) decode state makes every long-context cell trivial by construction —
that is the point of the architecture (DESIGN.md shape-cell notes).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_expand=2,
    norm="rmsnorm",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=64,
        vocab_size=256,
        ssm_state=4,
        dtype="float32",
        remat="none",
    )
