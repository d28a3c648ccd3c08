"""Step builders: the LM train step, prefill and decode step, meshless or
on a ("data", "model") mesh of any size (counterpart of
``repro/launch/steps.py``).

``build_train_step`` is the reference's step: the loss and its gradient
over ``cfg.num_microbatches`` microbatches accumulated in
``knobs.grad_accum_dtype``, their mean cast to f32, global-norm clipping at
``knobs.grad_clip``, then the optimizer ``cfg.optimizer`` names (Adam or
Adafactor). It runs eagerly and updates the parameters in place, where the
reference jits a step that donates them.

With ``mesh=None`` the steps run on plain tensors. With a mesh (a
:class:`~torch.distributed.device_mesh.DeviceMesh` with the axes
:func:`repro_torch.launch.mesh.make_host_mesh` gives) every leaf is a
DTensor, the counterpart of a ``jax.Array`` with a ``NamedSharding``: a
step places its parameters and optimizer state by
:func:`~repro_torch.sharding.specs.param_specs` and ``opt_state_specs``,
its batch by ``batch_specs`` and its cache by ``cache_specs`` (a leaf
already on its placements is taken as it is, as jit's ``in_shardings``
would), runs the model inside :func:`~repro_torch.sharding.ctx.use_sharding`
(plain tensors the model makes, such as position ranges, count as
replicated), and returns each output on the reference's out placements:
the parameters and state on theirs, the metrics replicated, the cache on
``cache_specs`` and the logits on (dp, tp). The collectives are DTensor's:
the loss, the clip's global norm and Adafactor's statistics reduce over the
whole mesh. A sharded step holds the specs it places its inputs by as
``step.in_specs``. The MoE dispatch runs in the groups the reference's
``_dp_groups`` chooses.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import torch
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.synthetic import input_specs
from repro_torch.models import lm
from repro_torch.nn.module import named_leaves
from repro_torch.optim import (AdafactorConfig, AdamConfig, adafactor_init,
                               adafactor_update, adam_init, adam_update,
                               clip_by_global_norm)
from repro_torch.sharding import specs as S
from repro_torch.sharding.ctx import ShardCtx, use_sharding

_ACCUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TrainKnobs:
    """Execution knobs independent of the architecture definition."""
    grad_clip: float = 1.0
    lr: float = 3e-4
    grad_accum_dtype: str = "float32"   # "bfloat16" = compressed accumulation


def _dp_groups(mesh, cfg: ModelConfig, shape: ShapeConfig | None) -> int:
    """MoE dispatch groups, the reference's rule
    (``repro/launch/steps.py:47-57``): one group per data shard where each
    holds at least 64 tokens, else one global group. Meshless, or without a
    shape, the rule gives 1."""
    if mesh is None or shape is None:
        return 1
    dp = S._axsize(mesh, S.mesh_axes(mesh, cfg.layout)["dp"])
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "train"
                                   else 1)
    if shape.global_batch % dp == 0 and tokens % dp == 0 \
            and tokens // dp >= 64:
        return dp
    return 1


def _shard_ctx(mesh, cfg: ModelConfig, shape: ShapeConfig) -> ShardCtx:
    ax = S.mesh_axes(mesh, cfg.layout)
    dp_size = S._axsize(mesh, ax["dp"])
    return ShardCtx(
        mesh=mesh,
        dp_axes=ax["dp"],
        tp_axis=ax["tp"],
        fsdp_axis=ax["fsdp"],
        seq_shard=cfg.seq_shard_activations and ax["tp"] is not None,
        batch_divisible=shape.global_batch % dp_size == 0,
    )


def _need_shape(mesh, shape, what: str) -> None:
    if mesh is not None and shape is None:
        raise ValueError(f"{what} on a mesh needs the cell's ShapeConfig: "
                         "the batch and cache placements depend on it")


def place(tree, specs: dict, mesh, prefix: str = ""):
    """``tree`` (nested dicts and lists) with each leaf a DTensor on the
    placements of ``specs[path]``: a DTensor already there as it is, one
    elsewhere redistributed, a plain tensor cut to this rank's block (every
    rank holds the same full tensor; nothing is sent)."""
    if isinstance(tree, dict):
        return {k: place(v, specs, mesh, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [place(v, specs, mesh, f"{prefix}/{i}")
                for i, v in enumerate(tree)]
    return _place_leaf(tree, specs[prefix], mesh)


def _place_leaf(x, spec: tuple, mesh):
    want = S.placements(spec, mesh)
    if isinstance(x, DTensor):
        return x if tuple(x.placements) == want else x.redistribute(mesh,
                                                                    want)
    return distribute_tensor(x, mesh, want, src_data_rank=None)


def _replicate(tree: dict, mesh) -> dict:
    """Each value as a replicated DTensor (a plain tensor the step made is
    the same on every rank)."""
    rep = (Replicate(),) * mesh.ndim
    return {k: v.redistribute(mesh, rep) if isinstance(v, DTensor)
            else DTensor.from_local(v, mesh, rep, run_check=False)
            for k, v in tree.items()}


def param_and_opt_shapes(cfg: ModelConfig, knobs: "TrainKnobs"):
    """The parameter tree and optimizer state of ``cfg`` on the ``meta``
    device: shapes and dtypes, no storage."""
    params = _param_shapes(cfg)
    _, opt_init, _ = make_optimizer(cfg, knobs)
    return params, opt_init(named_leaves(params))


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
    :func:`_dp_groups` groups (``shape``: the cell's batch and length).
    On a mesh the step takes and returns the trees on their placements
    (the module's docstring)."""
    _need_shape(mesh, shape, "build_train_step")
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

    if mesh is None:
        return step
    ctx = _shard_ctx(mesh, cfg, shape)
    params_shapes, opt_shapes = param_and_opt_shapes(cfg, knobs)
    pspecs = S.param_specs(params_shapes, cfg, mesh)
    ospecs = S.opt_state_specs(opt_shapes, cfg, mesh)
    bspecs = S.batch_specs(input_specs(cfg, shape)["batch"], cfg, shape,
                           mesh)

    def sharded_step(params, opt_state, batch):
        params = place(params, pspecs, mesh)
        opt_state = place(opt_state, ospecs, mesh)
        batch = place(batch, bspecs, mesh)
        with use_sharding(ctx), implicit_replication():
            params, opt_state, metrics = step(params, opt_state, batch)
            opt_state = place(opt_state, ospecs, mesh)
            return params, opt_state, _replicate(metrics, mesh)

    sharded_step.in_specs = (pspecs, ospecs, bspecs)
    return sharded_step


def _logits_spec(ctx: ShardCtx) -> tuple:
    return (ctx.dp, ctx.tp_axis)


def _param_shapes(cfg: ModelConfig) -> dict:
    return lm.init_params(cfg, generator=torch.Generator(), device="meta")


def _serving_specs(cfg: ModelConfig, mesh, shape: ShapeConfig):
    params_shapes = _param_shapes(cfg)
    cache_shapes = lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 device="meta")
    return (S.param_specs(params_shapes, cfg, mesh),
            S.cache_specs(cache_shapes, cfg, shape, mesh))


def build_prefill(cfg: ModelConfig, mesh=None,
                  shape: ShapeConfig | None = None):
    """``step(params, batch) -> (cache, last_logits)``: ``lm.prefill``
    without gradients, the cache sized ``shape.seq_len`` when a shape is
    given; its MoE dispatch in :func:`_dp_groups` groups."""
    _need_shape(mesh, shape, "build_prefill")
    max_seq = shape.seq_len if shape is not None else None
    dp_groups = _dp_groups(mesh, cfg, shape)

    @torch.no_grad()
    def step(params, batch):
        return lm.prefill(params, batch, cfg, max_seq=max_seq,
                          dp_groups=dp_groups)

    if mesh is None:
        return step
    ctx = _shard_ctx(mesh, cfg, shape)
    pspecs, cspecs = _serving_specs(cfg, mesh, shape)
    bspecs = S.batch_specs(input_specs(cfg, shape)["batch"], cfg, shape,
                           mesh)
    lspec = _logits_spec(ctx)

    @torch.no_grad()
    def sharded_step(params, batch):
        params = place(params, pspecs, mesh)
        batch = place(batch, bspecs, mesh)
        with use_sharding(ctx), implicit_replication():
            cache, logits = step(params, batch)
            return (place(cache, cspecs, mesh),
                    _place_leaf(logits, lspec, mesh))

    sharded_step.in_specs = (pspecs, bspecs)
    return sharded_step


def build_decode_step(cfg: ModelConfig, mesh=None,
                      shape: ShapeConfig | None = None):
    """``step(params, cache, batch) -> (cache, logits)``: ``lm.decode_step``
    without gradients; the cache is updated in place (on a mesh, in place
    when it comes on its placements)."""
    _need_shape(mesh, shape, "build_decode_step")

    @torch.no_grad()
    def step(params, cache, batch):
        return lm.decode_step(params, cache, batch, cfg)

    if mesh is None:
        return step
    ctx = _shard_ctx(mesh, cfg, shape)
    pspecs, cspecs = _serving_specs(cfg, mesh, shape)
    io = input_specs(cfg, shape)
    bspecs = S.batch_specs(io["batch"], cfg, shape, mesh)
    lspec = _logits_spec(ctx)

    @torch.no_grad()
    def sharded_step(params, cache, batch):
        params = place(params, pspecs, mesh)
        cache = place(cache, cspecs, mesh)
        batch = place(batch, bspecs, mesh)
        with use_sharding(ctx), implicit_replication():
            cache, logits = step(params, cache, batch)
            return (place(cache, cspecs, mesh),
                    _place_leaf(logits, lspec, mesh))

    sharded_step.in_specs = (pspecs, cspecs, bspecs)
    return sharded_step


def build_for_shape(cfg: ModelConfig, mesh, shape: ShapeConfig,
                    knobs: TrainKnobs = TrainKnobs()):
    """The step of ``shape.kind``: train, prefill or decode."""
    if shape.kind == "train":
        return build_train_step(cfg, mesh, knobs, shape)
    if shape.kind == "prefill":
        return build_prefill(cfg, mesh, shape)
    return build_decode_step(cfg, mesh, shape)


def lowering_inputs(cfg: ModelConfig, shape: ShapeConfig,
                    knobs: TrainKnobs = TrainKnobs()):
    """The argument tuple of :func:`build_for_shape`'s step for ``shape``'s
    kind, as ``meta`` tensors (shapes and dtypes, no storage): train ->
    (params, opt_state, batch); prefill -> (params, batch); decode ->
    (params, cache, batch)."""
    params_shapes, opt_shapes = param_and_opt_shapes(cfg, knobs)
    io = input_specs(cfg, shape)
    if shape.kind == "train":
        return (params_shapes, opt_shapes, io["batch"])
    if shape.kind == "prefill":
        return (params_shapes, io["batch"])
    return (params_shapes, io["cache"], io["batch"])
