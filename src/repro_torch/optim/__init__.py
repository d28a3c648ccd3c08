"""Optimizers and gradient utilities over named parameters (counterpart of
``repro.optim``). Adafactor and the int8-compressed all-reduce are not
ported yet."""
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update
from repro_torch.optim.grad_utils import clip_by_global_norm, global_norm
from repro_torch.optim.schedule import constant_lr, warmup_cosine

__all__ = [
    "adam_init", "adam_update", "AdamConfig",
    "warmup_cosine", "constant_lr",
    "clip_by_global_norm", "global_norm",
]
