"""Step builders for one device: the LM train step, prefill and decode step
(counterpart of ``repro/launch/steps.py``).

``build_train_step`` is the reference's step: the loss and its gradient
over ``cfg.num_microbatches`` microbatches accumulated in
``knobs.grad_accum_dtype``, their mean cast to f32, global-norm clipping at
``knobs.grad_clip``, then the optimizer ``cfg.optimizer`` names (Adam or
Adafactor). It runs eagerly and updates the parameters in place, where the
reference jits a step that donates them.

Sharding waits for the LM-sharding part of ROADMAP A4: the step makers take
a mesh of one device or None, and raise for a larger one. The train step
passes the MoE dispatch groups the reference's ``_dp_groups`` chooses,
which is 1 on one device.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.nn.module import named_leaves
from repro_torch.optim import (AdafactorConfig, AdamConfig, adafactor_init,
                               adafactor_update, adam_init, adam_update,
                               clip_by_global_norm)

_ACCUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TrainKnobs:
    """Execution knobs independent of the architecture definition."""
    grad_clip: float = 1.0
    lr: float = 3e-4
    grad_accum_dtype: str = "float32"   # "bfloat16" = compressed accumulation


def _check_mesh(mesh) -> None:
    if mesh is not None and mesh.size() != 1:
        raise NotImplementedError(
            f"a mesh of {mesh.size()} devices: LM sharding waits for "
            "ROADMAP A4; the LM steps run on one device")


def _dp_groups(mesh, cfg: ModelConfig, shape: ShapeConfig | None) -> int:
    """MoE dispatch groups, the reference's rule
    (``repro/launch/steps.py:47-57``): one group per data shard where each
    holds at least 64 tokens, else one global group. The data axis here is
    the mesh of one device (or none), so the rule gives 1."""
    dp = 1 if mesh is None else mesh.size()
    if shape is None:
        return 1
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "train"
                                   else 1)
    if shape.global_batch % dp == 0 and tokens % dp == 0 \
            and tokens // dp >= 64:
        return dp
    return 1


def make_optimizer(cfg: ModelConfig, knobs: TrainKnobs):
    """(config, init(leaves), update(leaves, grads, state)) of the optimizer
    that ``cfg.optimizer`` names, at ``knobs.lr``."""
    if cfg.optimizer == "adafactor":
        ocfg = AdafactorConfig(lr=knobs.lr)
        return (ocfg, partial(adafactor_init, cfg=ocfg),
                partial(adafactor_update, cfg=ocfg))
    ocfg = AdamConfig(lr=knobs.lr)
    return ocfg, partial(adam_init, cfg=ocfg), partial(adam_update, cfg=ocfg)


def _value_and_grad(params, leaves, batch, cfg: ModelConfig, dp_groups):
    """(total, metrics, {path: grad}) of ``lm.train_loss``; a leaf the loss
    does not reach (a nonparametric norm's placeholder) gets zeros."""
    total, metrics = lm.train_loss(params, batch, cfg, dp_groups)
    grads = torch.autograd.grad(total, list(leaves.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(t) if g is None else g
             for (k, t), g in zip(leaves.items(), grads)}
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _microbatches(batch: dict, m: int) -> list[dict]:
    """``batch`` cut into ``m`` along its batch axis; M-RoPE positions
    (3, B, S) along their second."""
    out = [{} for _ in range(m)]
    for k, v in batch.items():
        axis = 1 if k == "positions" else 0
        if v.shape[axis] % m:
            raise ValueError(f"batch {k!r} of {v.shape[axis]} rows does not "
                             f"split into {m} microbatches")
        for i, part in enumerate(torch.chunk(v, m, dim=axis)):
            out[i][k] = part
    return out


def build_train_step(cfg: ModelConfig, mesh=None,
                     knobs: TrainKnobs = TrainKnobs(),
                     shape: ShapeConfig | None = None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    with metrics ``loss``, ``aux_loss``, ``tokens`` (the microbatches'
    mean), ``grad_norm`` (before clipping) and ``loss_total``. The
    parameters are updated in place; the optimizer state is keyed by
    :func:`repro_torch.nn.named_leaves`' paths (``make_optimizer``'s
    init over those leaves makes it). The loss's MoE dispatch runs in
    :func:`_dp_groups` groups (``shape``: the cell's batch and length)."""
    _check_mesh(mesh)
    _, _, opt_update = make_optimizer(cfg, knobs)
    dp_groups = _dp_groups(mesh, cfg, shape)
    accum_dtype = _ACCUM_DTYPES[knobs.grad_accum_dtype]
    m = max(cfg.num_microbatches, 1)

    def step(params, opt_state, batch):
        leaves = named_leaves(params)
        for t in leaves.values():
            t.requires_grad_(True)
        if m == 1:
            loss, metrics, grads = _value_and_grad(params, leaves, batch,
                                                   cfg, dp_groups)
        else:
            acc = {k: torch.zeros(t.shape, dtype=accum_dtype, device=t.device)
                   for k, t in leaves.items()}
            loss_sum, mets = 0.0, []
            for mb in _microbatches(batch, m):
                loss_mb, met, g = _value_and_grad(params, leaves, mb, cfg,
                                                  dp_groups)
                acc = {k: a + g[k].to(accum_dtype) for k, a in acc.items()}
                loss_sum = loss_sum + loss_mb
                mets.append(met)
            grads = {k: (a / m).to(torch.float32) for k, a in acc.items()}
            loss = loss_sum / m
            metrics = {k: torch.stack([mt[k] for mt in mets]).mean(0)
                       for k in mets[0]}
        grads, gnorm = clip_by_global_norm(grads, knobs.grad_clip)
        opt_state = opt_update(leaves, grads, opt_state)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["loss_total"] = loss
        return params, opt_state, metrics

    return step


def build_prefill(cfg: ModelConfig, mesh=None,
                  shape: ShapeConfig | None = None):
    """``step(params, batch) -> (cache, last_logits)``: ``lm.prefill``
    without gradients, the cache sized ``shape.seq_len`` when a shape is
    given."""
    _check_mesh(mesh)
    max_seq = shape.seq_len if shape is not None else None

    @torch.no_grad()
    def step(params, batch):
        return lm.prefill(params, batch, cfg, max_seq=max_seq)

    return step


def build_decode_step(cfg: ModelConfig, mesh=None):
    """``step(params, cache, batch) -> (cache, logits)``: ``lm.decode_step``
    without gradients; the cache is updated in place."""
    _check_mesh(mesh)

    @torch.no_grad()
    def step(params, cache, batch):
        return lm.decode_step(params, cache, batch, cfg)

    return step
