"""Learning-based ablation baselines FC1/FC2/FC3 (paper §V-A Baselines); a
copy of ``repro/core/ablations.py`` over the port's ``PolicyConfig``.

Each keeps the MoD architecture and I/O of CoRaiS but replaces the
multi-head-attention alignment mechanism with a parameter-matched MLP in:
FC1 - the edge encoder; FC2 - the request encoder; FC3 - both.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.policy import PolicyConfig

VARIANTS = ("corais", "fc1", "fc2", "fc3")


def variant_config(base: PolicyConfig, variant: str) -> PolicyConfig:
    variant = variant.lower()
    if variant == "corais":
        return dataclasses.replace(base, edge_align="mha", req_align="mha")
    if variant == "fc1":
        return dataclasses.replace(base, edge_align="mlp", req_align="mha")
    if variant == "fc2":
        return dataclasses.replace(base, edge_align="mha", req_align="mlp")
    if variant == "fc3":
        return dataclasses.replace(base, edge_align="mlp", req_align="mlp")
    raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
