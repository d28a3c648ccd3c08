"""Parameter utilities shared by the port's modules (counterpart of
``repro/nn/module.py``)."""
from __future__ import annotations

import math

import torch
from torch import nn


def uniform_init(generator: torch.Generator, shape: tuple[int, ...],
                 fan_in: int | None = None) -> torch.Tensor:
    """Paper §V.A init: Uniform(-1/sqrt(d), 1/sqrt(d)) with d the input dim,
    drawn on the CPU from ``generator`` (f32)."""
    if fan_in is None:
        fan_in = shape[0] if len(shape) == 1 else shape[-2]
    bound = 1.0 / math.sqrt(max(fan_in, 1))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (2.0 * u - 1.0) * bound


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
