"""Optimizers and gradient utilities over named parameters (counterpart of
``repro.optim``)."""
from repro_torch.optim.adafactor import (AdafactorConfig, adafactor_init,
                                         adafactor_update)
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update
from repro_torch.optim.grad_utils import (clip_by_global_norm,
                                         compressed_psum, dequantize_int8,
                                         global_norm, quantize_int8)
from repro_torch.optim.schedule import constant_lr, warmup_cosine

__all__ = [
    "adam_init", "adam_update", "AdamConfig",
    "adafactor_init", "adafactor_update", "AdafactorConfig",
    "warmup_cosine", "constant_lr",
    "clip_by_global_norm", "global_norm",
    "quantize_int8", "dequantize_int8", "compressed_psum",
]
