"""S-sample batch REINFORCE for CoRaiS (paper §IV-B, eqs 20-21) in PyTorch;
counterpart of the static half of ``repro/core/train.py``.

One forward pass per instance yields the full factorized distribution;
S assignments are sampled from it, the shared-baseline advantage
A(pi_s) = L(pi_s) - mean_i L(pi_i) weights the log-prob gradient, and an
entropy bonus (eq 20) keeps exploration alive. Loss (eq 21):

    L(theta|D) = E_g[ C1 * sum_s log p(pi_s) A(pi_s) - C2 * H(g) ]

Paper hyperparameters: Adam lr 1e-5, batch 128 instances, S = 64,
C1 = 10, C2 = 0.5, uniform(-1/sqrt d) init.

Where the reference is functional, the port updates in place: the step
writes the new parameters into the policy's ``nn.Parameter``s, and the
encoder's ``training=True`` pass updates the BatchNorm buffers (the
reference returns the new state in ``aux["state"]``). So :func:`rl_loss`
runs the encoder exactly once, and a caller that evaluates it twice on one
policy (finite differences) snapshots and restores the buffers itself.
The temporal trainer (engine rollouts) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpointer import train_tree
from repro_torch.core import instances as inst_lib
from repro_torch.core.decode import (assignment_log_prob, greedy_decode,
                                     sample_assignments)
from repro_torch.core.objective import makespan
from repro_torch.core.policy import (CoRaiSPolicy, PolicyConfig,
                                     corais_encode, corais_score)
from repro_torch.nn.module import param_tree
from repro_torch.optim import (AdamConfig, adam_init, adam_update,
                               clip_by_global_norm)


@dataclasses.dataclass(frozen=True)
class RLConfig:
    policy: PolicyConfig = PolicyConfig()
    instance: inst_lib.InstanceConfig = inst_lib.InstanceConfig()
    batch_size: int = 128
    num_samples: int = 64          # S
    c1: float = 10.0
    c2: float = 0.5
    lr: float = 1e-5
    grad_clip: float = 1.0
    num_batches: int = 40000
    seed: int = 0
    log_every: int = 10


def to_device(batch: dict, device) -> dict:
    """A numpy instance batch as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def rl_loss(policy: CoRaiSPolicy, batch: dict, cfg: RLConfig, *,
            generator: Optional[torch.Generator] = None,
            samples: Optional[torch.Tensor] = None):
    """Surrogate loss over a batch of instances (leading batch axis);
    returns (loss, aux). ``samples`` (S, B, Z) injects the sampled
    assignments; without them S are drawn from ``generator`` (on the
    batch's device) from the detached log-probs. Updates the BatchNorm
    buffers in place (one encoder pass)."""
    c_emb, h_emb = corais_encode(policy, batch, training=True)
    log_probs = corais_score(policy, c_emb, h_emb, batch["edge_mask"])
    rmask = batch["req_mask"]

    # --- S samples from the factorized policy (no grad through sampling)
    if samples is None:
        samples = sample_assignments(generator, log_probs, cfg.num_samples)
    costs = makespan(batch, samples)  # (S, B)
    adv = costs - costs.mean(0, keepdim=True)

    logp_pi = assignment_log_prob(log_probs, samples, rmask)  # (S, B)
    reinforce = (logp_pi * adv.detach()).sum(0)  # (B,)

    # --- entropy (eq 20), over real (request, edge) cells
    ent = -(torch.exp(log_probs) * log_probs).sum(-1)  # (B, Z)
    ent = (ent * rmask).sum(-1)  # (B,)

    loss = torch.mean(cfg.c1 * reinforce - cfg.c2 * ent)
    aux = {
        "cost_mean": costs.mean(),
        "cost_best": costs.amin(0).mean(),
        "entropy": ent.mean(),
    }
    return loss, aux


def loss_and_grads(policy: CoRaiSPolicy, batch: dict, cfg: RLConfig, **kw):
    """(loss, aux, {"/"-path: gradient}), loss and aux detached; a
    parameter the loss does not reach (the admission head) gets a zero
    gradient, as under jax.grad."""
    params = param_tree(policy)
    loss, aux = rl_loss(policy, batch, cfg, **kw)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)})


def make_train_step(cfg: RLConfig, adam_cfg: Optional[AdamConfig] = None):
    """Returns (step, adam_cfg). ``step(policy, opt_state, batch, *,
    generator=None, samples=None) -> (opt_state, metrics)``: value and
    grad, global-norm clip, then the port's Adam, eagerly; the policy's
    parameters and norm buffers are updated in place. Metrics are device
    scalars."""
    adam_cfg = adam_cfg or AdamConfig(lr=cfg.lr)

    def step(policy, opt_state, batch, *, generator=None, samples=None):
        loss, aux, grads = loss_and_grads(policy, batch, cfg,
                                          generator=generator, samples=samples)
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        opt_state = adam_update(param_tree(policy), grads, opt_state, adam_cfg)
        return opt_state, {"loss": loss, "grad_norm": gnorm, **aux}

    return step, adam_cfg


@torch.no_grad()
def greedy_eval(policy: CoRaiSPolicy, batch: dict) -> torch.Tensor:
    """Mean greedy makespan on a batch (no sampling)."""
    c_emb, h_emb = corais_encode(policy, batch, training=False)
    log_probs = corais_score(policy, c_emb, h_emb, batch["edge_mask"])
    return makespan(batch, greedy_decode(log_probs)).mean()


def batch_seed(seed: int, b: int) -> int:
    """Seed of batch ``b``'s sampling generator: a function of the batch
    index alone, so a resumed run draws what an uninterrupted one would."""
    return seed * 1_000_003 + b


def train(
    cfg: RLConfig,
    num_batches: Optional[int] = None,
    policy: Optional[CoRaiSPolicy] = None,
    opt_state: Optional[dict] = None,
    callback: Optional[Callable] = None,
    checkpointer=None,
    start_batch: int = 0,
    device=None,
):
    """Train CoRaiS on freshly generated synthetic instances (paper §IV-B).

    Returns (policy, opt_state, history); each history row holds the step's
    metrics, ``sec`` (the step, ending in the metrics' device-to-host copy)
    and ``data_sec`` (making the batch on the host and copying it over).
    Runs on CUDA unless ``device`` says otherwise (a given policy brings its
    own device). Instances come from the reference's numpy stream
    (``np.random.default_rng(cfg.seed + 7919 * start_batch)``); sampling
    draws from a device generator reseeded per batch. ``checkpointer``
    only saves. To resume, restore its newest save with
    ``checkpointer.restore_latest()``, load it into a policy with
    ``load_train_state`` (which returns the optimizer state), and pass
    both back in with ``start_batch=checkpointer.latest_step() + 1``.
    """
    num_batches = num_batches if num_batches is not None else cfg.num_batches
    if policy is None:
        policy = CoRaiSPolicy(cfg.policy,
                              generator=torch.Generator().manual_seed(cfg.seed),
                              device=resolve_device(device))
    device = policy.device
    rng = np.random.default_rng(cfg.seed + 7919 * start_batch)
    gen = torch.Generator(device=device)
    adam_cfg = AdamConfig(lr=cfg.lr)
    if opt_state is None:
        opt_state = adam_init(param_tree(policy), adam_cfg)
    step_fn, _ = make_train_step(cfg, adam_cfg)

    history = []
    for b in range(start_batch, start_batch + num_batches):
        t_data = time.perf_counter()
        batch = to_device(inst_lib.generate_batch(rng, cfg.instance,
                                                  cfg.batch_size), device)
        gen.manual_seed(batch_seed(cfg.seed, b))
        t0 = time.perf_counter()
        opt_state, metrics = step_fn(policy, opt_state, batch, generator=gen)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["batch"] = b
        metrics["sec"] = time.perf_counter() - t0
        metrics["data_sec"] = t0 - t_data  # host: instances + copy
        history.append(metrics)
        if callback is not None and (b % cfg.log_every == 0):
            callback(metrics)
        if checkpointer is not None and checkpointer.should_save(b):
            checkpointer.save(b, train_tree(policy, opt_state))
    return policy, opt_state, history
