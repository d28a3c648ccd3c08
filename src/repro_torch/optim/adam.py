"""Adam over a dict of named tensors; counterpart of
``repro/optim/adam.py``.

The update is the reference's, term for term: eps is added after the
bias-corrected ``sqrt(vhat)``, then the decoupled weight decay
(``weight_decay * p``); the moments are computed in f32 and stored in
``moment_dtype``; the parameter is updated in f32 and cast back to its
dtype. ``torch.optim.Adam`` divides by
``sqrt(v) / sqrt(bc2) + eps`` instead, which is a different number, so it
is not used. Parameters are updated in place (they are the policy's
``nn.Parameter``s); the moments live in the returned state, keyed by the
same "/"-paths as the parameters, so the state checkpoints in the
reference's layout.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    moment_dtype: torch.dtype = torch.float32

    def resolve_lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)


def adam_init(params: dict[str, torch.Tensor], cfg: AdamConfig) -> dict:
    """{"step": int32 scalar, "m": {path: zeros}, "v": {path: zeros}}, the
    moments in ``cfg.moment_dtype``."""
    device = next(iter(params.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
             for k, p in params.items()}
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "m": zeros,
            "v": {k: torch.zeros_like(z) for k, z in zeros.items()}}


@torch.no_grad()
def adam_update(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
                opt_state: dict, cfg: AdamConfig) -> dict:
    """One Adam step: writes the new values into ``params`` in place and
    returns the new optimizer state."""
    step = opt_state["step"] + 1
    lr = cfg.resolve_lr(step)
    stepf = step.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=step.device)
    bc1 = 1.0 - (one * cfg.b1) ** stepf
    bc2 = 1.0 - (one * cfg.b2) ** stepf
    new_m, new_v = {}, {}
    for key, p in params.items():
        g = grads[key].to(torch.float32)
        m = cfg.b1 * opt_state["m"][key].float() + (1 - cfg.b1) * g
        v = (cfg.b2 * opt_state["v"][key].float()
             + (1 - cfg.b2) * torch.square(g))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
        new_m[key] = m.to(cfg.moment_dtype)
        new_v[key] = v.to(cfg.moment_dtype)
    return {"step": step, "m": new_m, "v": new_v}
