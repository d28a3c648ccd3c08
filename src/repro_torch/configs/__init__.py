"""Architecture registry: ``--arch <id>`` resolves here (a copy of
``repro.configs``, which the port may not import).

Each assigned architecture has its own module with CONFIG (the full,
published configuration) and ``reduced()`` (a small same-family config for
CPU tests). The copies are plain dataclasses and are held field for field
against the reference's by ``tests/test_torch_lm.py``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    ModelConfig,
    ShapeConfig,
    shape_applicable,
)

_MODULES = {
    "hymba-1.5b": "repro_torch.configs.hymba_1p5b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch]).reduced()


__all__ = [
    "ARCH_IDS", "get_config", "get_reduced_config", "ModelConfig",
    "ShapeConfig", "SHAPES", "ALL_SHAPES", "TRAIN_4K", "PREFILL_32K",
    "DECODE_32K", "LONG_500K", "shape_applicable",
]
