"""The LM model zoo's dense, SSM and hybrid families in PyTorch
(counterpart of ``repro.models``): attention prefill through kernel B4,
attention decode through kernel B5, the SSM prefill scan through kernel
B6."""
from repro_torch.models.lm import (decode_step, init_cache, init_params,
                                   prefill)

__all__ = ["init_params", "prefill", "decode_step", "init_cache"]
