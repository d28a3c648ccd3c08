"""Parameter utilities shared by the port's modules (counterpart of
``repro/nn/module.py``)."""
from __future__ import annotations

import math

import torch
from torch import nn


def uniform_init(generator: torch.Generator, shape: tuple[int, ...],
                 fan_in: int | None = None, device=None) -> torch.Tensor:
    """Paper §V.A init: Uniform(-1/sqrt(d), 1/sqrt(d)) with d the input dim,
    drawn in f32 from ``generator`` on ``device`` (the generator's own
    device when None)."""
    if fan_in is None:
        fan_in = shape[0] if len(shape) == 1 else shape[-2]
    bound = 1.0 / math.sqrt(max(fan_in, 1))
    device = generator.device if device is None else torch.device(device)
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    return (2.0 * u - 1.0) * bound


def normal_init(generator: torch.Generator, shape: tuple[int, ...],
                stddev: float = 0.02, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """``stddev * N(0, 1)`` drawn in f32 from ``generator`` on ``device``
    (the generator's own device when None), then cast to ``dtype``. The
    reference's ``normal_init`` draws in the target dtype; jax and torch
    draws never agree, so parity tests bridge the reference's weights."""
    device = generator.device if device is None else torch.device(device)
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (stddev * x).to(dtype)


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def named_leaves(tree, prefix: str = "") -> dict:
    """{"/"-path: leaf} of a tree of nested dicts and lists, a list's items
    under their index: an LM's layer leaves as ``layers/<i>/<name>``,
    where the reference stacks them on a leading L axis under
    ``layers/<name>``."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for key, sub in items:
            out.update(named_leaves(sub, f"{prefix}/{key}" if prefix
                                    else str(key)))
        return out
    return {prefix: tree}


def param_tree(module: nn.Module) -> dict[str, nn.Parameter]:
    """{reference "/"-path: parameter}, e.g. ``edge_layers/0/align/mha/wq``."""
    return {name.replace(".", "/"): p for name, p in module.named_parameters()}


def state_tree(module: nn.Module) -> dict[str, torch.Tensor]:
    """{reference "/"-path: buffer} of the persistent buffers (the norm
    state the reference carries beside its parameters)."""
    params = {n for n, _ in module.named_parameters()}
    keys = set(module.state_dict()) - params
    return {name.replace(".", "/"): b for name, b in module.named_buffers()
            if name in keys}
