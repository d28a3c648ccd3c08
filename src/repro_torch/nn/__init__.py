"""PyTorch counterparts of ``repro.nn``."""
from repro_torch.nn.layers import MHA, BatchNorm, LayerNorm, Linear
from repro_torch.nn.module import param_count, uniform_init

__all__ = ["Linear", "MHA", "BatchNorm", "LayerNorm", "param_count",
           "uniform_init"]
