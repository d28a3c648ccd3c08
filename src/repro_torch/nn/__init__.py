"""PyTorch counterparts of ``repro.nn``."""
from repro_torch.nn.layers import MHA, BatchNorm, LayerNorm, Linear
from repro_torch.nn.module import (param_count, param_tree, state_tree,
                                   uniform_init)

__all__ = ["Linear", "MHA", "BatchNorm", "LayerNorm", "param_count",
           "param_tree", "state_tree", "uniform_init"]
