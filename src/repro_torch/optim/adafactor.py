"""Adafactor (Shazeer & Stern 2018) with factored second moments, over a
dict of named tensors; counterpart of ``repro/optim/adafactor.py``.

The update is the reference's, term for term: ``beta2 = 1 - t^-decay``;
``eps1`` added to g^2; for a leaf whose two trailing dims are both at
least ``min_dim_size_to_factor`` the row and column means of g^2 in f32,
else the full second moment; the RMS clip of the preconditioned update;
the ``eps2`` floor of the parameter scale; the optional weight decay. The
parameter is updated in f32 and cast back to its dtype, in place.

The state has the port's Adam layout, keyed by the parameters' "/"-paths:
``{"step", "v": {path: {"vr", "vc"} or {"v"}}}``. The reference stacks an
LM's layers on a leading L axis, so its RMS of the update and its
parameter scale are taken over all layers of a leaf at once. Here the
leaves ``layers/<i>/<rest>`` of one ``<rest>`` (and whisper's
``enc_layers/<i>/<rest>``) are that stacked leaf (:func:`stack_key`), and
the two statistics are taken over the group. Where the reference factors a
stacked 1-D leaf over its layer axis (L and the width both at least
``min_dim_size_to_factor``), the group is factored so: one slot under the
stacked leaf's path, ``vr`` (L,) and ``vc`` (width,), the reference's
layout, which a checkpoint keeps (:func:`factored_groups`).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable

import torch

_LAYER = re.compile(r"^((?:enc_)?layers)/\d+/")


def stack_key(path: str) -> str:
    """The reference's path of the stacked leaf that ``path`` is one layer
    of (``layers/3/attn/wq`` -> ``layers/attn/wq``, ``enc_layers/1/mlp/wi``
    -> ``enc_layers/mlp/wi``); other paths are their own."""
    return _LAYER.sub(r"\1/", path)


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 1e-2
    decay: float = 0.8          # beta2 hat: 1 - step^-decay schedule
    eps1: float = 1e-30
    eps2: float = 1e-3
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    min_dim_size_to_factor: int = 128

    def resolve_lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)


def _factored(shape, cfg: AdafactorConfig) -> bool:
    return (len(shape) >= 2 and shape[-1] >= cfg.min_dim_size_to_factor
            and shape[-2] >= cfg.min_dim_size_to_factor)


def _groups(params: dict) -> dict[str, list[str]]:
    """{stacked leaf's path: the paths of its layers, in layer order}."""
    groups: dict[str, list[str]] = {}
    for key in params:
        groups.setdefault(stack_key(key), []).append(key)
    return groups


def factored_groups(params: dict, cfg: AdafactorConfig) -> dict:
    """{stacked leaf's path: its layers' paths} of each group of per-layer
    1-D leaves that the reference, holding them stacked (L, width),
    factors over the layer axis (L and width both at least
    ``min_dim_size_to_factor``): their slot is the stacked leaf's."""
    out = {}
    for name, keys in _groups(params).items():
        shape = tuple(params[keys[0]].shape)
        if (len(keys) > 1 and len(shape) == 1
                and _factored((len(keys),) + shape, cfg)):
            out[name] = keys
    return out


def adafactor_init(params: dict[str, torch.Tensor],
                   cfg: AdafactorConfig) -> dict:
    """{"step": int32 scalar, "v": {path: slot}}, every slot f32 zeros:
    {"vr" (..., rows), "vc" (..., cols)} for a factored leaf, {"v"} of the
    leaf's shape otherwise; a group of :func:`factored_groups` has one
    slot {"vr" (L,), "vc" (width,)} under the stacked leaf's path."""
    device = next(iter(params.values())).device
    stacked = factored_groups(params, cfg)
    in_stack = {k for keys in stacked.values() for k in keys}

    def slot(p):
        z = dict(dtype=torch.float32, device=p.device)
        if _factored(p.shape, cfg):
            return {"vr": torch.zeros(p.shape[:-1], **z),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
        return {"v": torch.zeros(p.shape, **z)}

    slots = {k: slot(p) for k, p in params.items() if k not in in_stack}
    for name, keys in stacked.items():
        p = params[keys[0]]
        z = dict(dtype=torch.float32, device=p.device)
        slots[name] = {"vr": torch.zeros((len(keys),), **z),
                       "vc": torch.zeros(p.shape, **z)}
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "v": slots}


def _mean_square(tensors) -> torch.Tensor:
    """The mean of x^2 over all entries of ``tensors`` taken as one leaf."""
    n = sum(t.numel() for t in tensors)
    return torch.stack([torch.square(t).sum() for t in tensors]).sum() / n


@torch.no_grad()
def adafactor_update(params: dict[str, torch.Tensor],
                     grads: dict[str, torch.Tensor], opt_state: dict,
                     cfg: AdafactorConfig) -> dict:
    """One Adafactor step: writes the new values into ``params`` in place
    and returns the new optimizer state."""
    step = opt_state["step"] + 1
    t = step.to(torch.float32)
    beta2 = 1.0 - t ** (-cfg.decay)
    lr = cfg.resolve_lr(step)
    precond, new_slots = {}, {}

    def factored(g, slot):
        g2 = torch.square(g) + cfg.eps1
        vr = beta2 * slot["vr"] + (1 - beta2) * g2.mean(-1)
        vc = beta2 * slot["vc"] + (1 - beta2) * g2.mean(-2)
        denom_r = vr / vr.mean(-1, keepdim=True)
        return (g * torch.rsqrt(denom_r[..., None])
                * torch.rsqrt(vc[..., None, :])), {"vr": vr, "vc": vc}

    stacked = factored_groups(params, cfg)
    for name, keys in stacked.items():  # factored as the stacked (L, width)
        g = torch.stack([grads[k].to(torch.float32) for k in keys])
        pre, new_slots[name] = factored(g, opt_state["v"][name])
        precond.update(zip(keys, pre.unbind(0)))
    in_stack = {k for keys in stacked.values() for k in keys}
    for key, p in params.items():
        if key in in_stack:
            continue
        g = grads[key].to(torch.float32)
        slot = opt_state["v"][key]
        if "vr" in slot:
            precond[key], new_slots[key] = factored(g, slot)
        else:
            g2 = torch.square(g) + cfg.eps1
            v = beta2 * slot["v"] + (1 - beta2) * g2
            precond[key] = g * torch.rsqrt(v)
            new_slots[key] = {"v": v}
    for keys in _groups(params).values():
        # update clipping (RMS of the preconditioned update) and the
        # parameter scale, each over the whole stacked leaf
        rms = torch.sqrt(_mean_square([precond[k] for k in keys]) + 1e-30)
        clip = torch.clamp(rms / cfg.clip_threshold, min=1.0)
        scale = torch.clamp(torch.sqrt(_mean_square(
            [params[k].float() for k in keys])), min=cfg.eps2)
        for key in keys:
            p = params[key]
            delta = lr * scale * (precond[key] / clip)
            if cfg.weight_decay:
                delta = delta + lr * cfg.weight_decay * p.float()
            p.copy_((p.float() - delta).to(p.dtype))
    return {"step": step, "v": new_slots}
