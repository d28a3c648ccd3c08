"""The LM model zoo's dense family in PyTorch (counterpart of
``repro.models``): prefill through kernel B4, decode through kernel B5."""
from repro_torch.models.lm import (decode_step, init_cache, init_params,
                                   prefill)

__all__ = ["init_params", "prefill", "decode_step", "init_cache"]
