"""PyTorch/CUDA port of the CoRaiS scheduler (the JAX package ``repro`` is
the reference it is tested against).

The layout mirrors ``repro``: ``repro_torch/core/policy.py`` is the
counterpart of ``repro/core/policy.py``, and so on. The port never imports
``jax`` or ``repro``; it keeps its own copies of the numpy modules it needs.

Device rule: every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``. Asking for the default device on a machine without CUDA
raises; nothing quietly falls back to the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` (the current card) by
    default, else what the caller names. Raises when the default is asked
    for and no CUDA device is visible."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
