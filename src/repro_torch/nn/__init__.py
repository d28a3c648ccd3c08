"""PyTorch counterparts of ``repro.nn``."""
from repro_torch.nn.layers import (MHA, BatchNorm, LayerNorm, Linear,
                                   nonparametric_layernorm)
from repro_torch.nn.module import (named_leaves, normal_init, param_count,
                                   param_tree, state_tree, uniform_init)

__all__ = ["Linear", "MHA", "BatchNorm", "LayerNorm",
           "nonparametric_layernorm", "named_leaves", "normal_init",
           "param_count", "param_tree", "state_tree", "uniform_init"]
