"""Policy-head kernels: hand-written CUDA (``policy_score``), their plain
PyTorch versions (``ref``) and the device-dispatching wrappers (``ops``)."""
