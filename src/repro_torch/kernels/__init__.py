"""The port's kernels: hand-written CUDA for the policy head (B1-B3,
``policy_score``), the LM attention (B4 ``flash_attention`` and its
backward B4b ``flash_attention_bwd``, B5 ``decode_attention``) and the
mamba-1 selective scan (B6 ``mamba_scan``), their shared build helper
(``build``), their plain PyTorch versions (``ref``) and the
device-dispatching wrappers (``ops``)."""
