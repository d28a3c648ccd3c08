"""The LM model zoo's dense, MoE, VLM-backbone, SSM and hybrid families in
PyTorch (counterpart of ``repro.models``): attention prefill and training
through kernel B4 (its backward kernel B4b), attention
decode through kernel B5, the SSM prefill scan through kernel B6; the MoE
layer's routing, dispatch and expert products in plain PyTorch, as the
reference computes them in jnp."""
from repro_torch.models.lm import (decode_step, init_cache, init_params,
                                   prefill, train_loss)

__all__ = ["init_params", "train_loss", "prefill", "decode_step",
           "init_cache"]
