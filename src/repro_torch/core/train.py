"""REINFORCE training for CoRaiS in PyTorch; counterpart of
``repro/core/train.py``: S-sample batch REINFORCE on static instances
(paper §IV-B, eqs 20-21), and temporal REINFORCE on batched engine
rollouts (below :class:`TemporalRLConfig`).

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
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpointer import load_train_state, train_tree
from repro_torch.core import instances as inst_lib
from repro_torch.core.decode import (BlockDraws, assignment_log_prob,
                                     greedy_decode, gumbel_argmax,
                                     sample_assignments, uniform)
from repro_torch.core.objective import makespan
from repro_torch.core.policy import (CoRaiSPolicy, PolicyConfig, corais_admit,
                                     corais_encode, corais_score)
from repro_torch.launch.mesh import mesh_axis
from repro_torch.nn.module import param_tree
from repro_torch.optim import (AdamConfig, adam_init, adam_update,
                               clip_by_global_norm)
from repro_torch.resilience import faults as faults_lib
from repro_torch.resilience.policies import nearest_alive
from repro_torch.serving import engine as engine_lib
from repro_torch.serving.engine import EngineConfig
from repro_torch.sharding.specs import (arrival_specs, engine_state_specs,
                                        local_block)
from repro_torch.workloads import scenarios as scenarios_lib
from repro_torch.workloads.batch import (compile_device_plan,
                                         materialize_round_batch,
                                         materialize_round_batch_device)


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


def _grads(policy, loss, aux):
    """(loss, aux, {"/"-path: gradient}), loss and aux detached; a
    parameter the loss does not reach (the admission head) gets a zero
    gradient, as under jax.grad."""
    params = param_tree(policy)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)})


def loss_and_grads(policy: CoRaiSPolicy, batch: dict, cfg: RLConfig, **kw):
    """:func:`rl_loss` and its gradients as (loss, aux, {"/"-path:
    gradient}), detached."""
    return _grads(policy, *rl_loss(policy, batch, cfg, **kw))


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
    only saves, and its last save has landed when ``train`` returns. To resume, restore its newest save with
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
    if checkpointer is not None:
        checkpointer.wait()  # a caller may read the checkpoint on return
    return policy, opt_state, history


# ---------------------------------------------------------------------------
# Temporal REINFORCE on batched engine rollouts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TemporalRLConfig:
    """REINFORCE over whole serving rollouts instead of i.i.d. static
    snapshots: the policy schedules every round of a scenario-conditioned
    episode inside :mod:`repro_torch.serving.engine`, and the rollout
    return (mean response time over the episode's completed requests)
    replaces the single-round makespan as the learning signal (the
    reference's fields, with their meaning)."""

    policy: PolicyConfig = PolicyConfig()
    engine: EngineConfig = EngineConfig()
    scenario: str = "uniform_iid"   # workloads scenario registry name
    batch_size: int = 16            # parallel rollouts (batched instances)
    c1: float = 1.0
    c2: float = 0.5
    lr: float = 1e-5
    grad_clip: float = 1.0
    num_batches: int = 1000
    seed: int = 0
    log_every: int = 10
    # Resilience training (the chaos-scenario path). Episodes are fault-
    # injected from the scenario's registered FaultSpec (or ``fault_spec``
    # here, which wins); ``admission=True`` samples the policy's admit head
    # per request and trains it jointly with dispatch. With ``slo > 0`` the
    # episode cost adds ``slo_penalty * slo_violation_frac``, where sheds,
    # drops and stranded requests all count as violations.
    fault_spec: Optional[faults_lib.FaultSpec] = None
    admission: bool = False
    slo: float = 0.0
    slo_penalty: float = 0.0
    # Deadline-aware training: with ``deadline_penalty > 0`` the episode
    # cost adds ``deadline_penalty * deadline_miss_frac`` (committed
    # finite-deadline requests that finished late or never).
    deadline_penalty: float = 0.0
    # Train only the admission head; every other gradient is zeroed.
    freeze_dispatch: bool = False
    # Device episodes: ``device_episodes=True`` draws arrivals (and fault
    # rows) on the card (workloads.materialize_round_batch_device), and
    # ``epoch_len`` K > 1 runs K updates per epoch step with the metrics
    # drained once per epoch. Either routes through the epoch trainer.
    device_episodes: bool = False
    epoch_len: int = 1


def _episode(policy, sim_state, arrivals, cfg: TemporalRLConfig, generator,
             actions, admits):
    """Roll a batch of episodes through the engine with the policy deciding
    every round. Returns (final drained state, per-round log p(actions)
    (R, B), per-round entropies (R, B)); the log-probs and entropies carry
    the graph of the encoder, the head and the admit head, nothing else.

    Every round draws the dispatch by the Gumbel-max rule
    (:func:`repro_torch.core.decode.gumbel_argmax`) and the admits from
    uniform noise. With ``generator`` a :class:`~repro_torch.core.decode
    .BlockDraws` the batch is a block of a global batch: the noise is drawn
    for the global batch and the block's rows kept, so an element's draws
    do not depend on how the batch is sharded."""
    ecfg = cfg.engine
    fault_mode = "alive" in arrivals
    sim = sim_state
    logps, ents = [], []
    for r in range(arrivals["size"].shape[1]):
        arr = {k: v[:, r] for k, v in arrivals.items()}
        with torch.no_grad():
            sim = engine_lib.advance(sim, sim["t"] + ecfg.round_interval,
                                     ecfg)
            ready_offset = None
            if fault_mode:
                # the engine's two-step admission failover (step_round):
                # arrivals re-admitted by the second step sort after native
                # ones
                arr["src"] = nearest_alive(
                    sim["w"], sim["alive"] > 0,
                    torch.clamp(arr["src"].to(torch.int32), 0,
                                ecfg.num_edges - 1))
                sim = engine_lib.apply_faults(sim, arr, ecfg)
                alive = sim["alive"] > 0
                readmitted = ~torch.gather(alive, 1, arr["src"].long())
                ready_offset = engine_lib.RETRY_EPS * readmitted
                arr["src"] = nearest_alive(sim["w"], alive, arr["src"])
            inst = engine_lib.round_instance(sim, arr, ecfg)
        # evaluation-mode norms on the whole batch: an untrained BatchNorm
        # pools its fallback statistics over all B instances, and the
        # gradient flows through them (the reference encodes the batched
        # instance, not under vmap)
        c_emb, h_emb = corais_encode(policy, inst, training=False)
        log_probs = corais_score(policy, c_emb, h_emb, inst["edge_mask"])
        act = (gumbel_argmax(generator, log_probs)
               if actions is None else actions[r].long())
        rmask = inst["req_mask"]
        ent = (-(torch.exp(log_probs) * log_probs).sum(-1) * rmask).sum(-1)
        if cfg.admission:
            logits = corais_admit(policy, c_emb, h_emb, inst["edge_mask"])
            if admits is None:
                u = uniform(generator, logits.shape, logits.device)
                admit = u < torch.sigmoid(logits.detach())
            else:
                admit = admits[r].bool()
            logp_admit = torch.where(
                rmask, torch.where(admit, F.logsigmoid(logits),
                                   F.logsigmoid(-logits)), 0.0).sum(-1)
            # a shed request's dispatch never executes: drop it from the
            # dispatch log-prob to cut gradient variance (still unbiased)
            logp = (assignment_log_prob(log_probs, act, rmask & admit)
                    + logp_admit)
        else:
            admit = torch.ones_like(rmask)
            logp = assignment_log_prob(log_probs, act, rmask)
        with torch.no_grad():
            sim = engine_lib.commit(sim, arr, act, ecfg, admit=admit,
                                    ready_offset=ready_offset)
        logps.append(logp)
        ents.append(ent)
    with torch.no_grad():
        sim = engine_lib.advance(sim, engine_lib.DRAIN_HORIZON, ecfg)
    return sim, torch.stack(logps), torch.stack(ents)


def temporal_rl_loss(policy: CoRaiSPolicy, sim_state: dict, arrivals: dict,
                     cfg: TemporalRLConfig, *,
                     generator: Optional[torch.Generator] = None,
                     actions: Optional[torch.Tensor] = None,
                     admits: Optional[torch.Tensor] = None,
                     group=None):
    """Surrogate loss over a batch of rollouts; returns (loss, aux).
    ``sim_state`` is a (B,)-batched engine state, ``arrivals`` (B, R, A)
    padded round batches (numpy or tensors; moved to the state's device).

    Every round the policy's factorized distribution is sampled from
    ``generator`` (on the state's device), or ``actions`` (R, B, A) and,
    with ``cfg.admission``, ``admits`` (R, B, A) inject the draws, as
    ``rl_loss``'s ``samples=`` does. The episode return is the mean
    response time over completed requests (plus the SLO and deadline
    penalties the config asks for), with the batch-mean baseline.

    The round is the reference's loss body, not ``step_round``: no
    breaker, probe cap, admission heuristic or dispatch clamp; only the
    two-step source failover and ``commit`` with the policy's own admit.
    The engine's updates run without gradient; the graph holds the
    encoder, the head (``corais_score``: B1 forward, B2 backward on the
    card) and the admit head.

    With ``group`` (a ``torch.distributed`` process group) the batch is
    this rank's block of a global batch, the ranks' blocks in rank order,
    and ``actions``/``admits`` are the block's. The draws are the global
    batch's rows (a :class:`~repro_torch.core.decode.BlockDraws` over
    ``generator``, :func:`_episode`), the REINFORCE baseline is the global
    batch mean and the aux metrics are global means (``cost_best`` the
    global min), from one SUM and one MIN all-reduce; the loss itself
    stays this block's (the update averages the gradients)."""
    arrivals = engine_lib._to_device(arrivals, sim_state["t"].device)
    if group is not None:
        b, rank = sim_state["t"].shape[0], dist.get_rank(group)
        if rank < 0:
            raise ValueError("this rank is not a member of the group")
        generator = BlockDraws(generator, rank * b,
                               dist.get_world_size(group) * b)
    sim, logps, ents = _episode(policy, sim_state, arrivals, cfg, generator,
                                actions, admits)

    committed = sim["slot_edge"] >= 0                        # (B, Z)
    # a fault trajectory can strand slots on a dead-at-horizon edge with
    # finish == INF; mean response is over realized completions only
    done = committed & (sim["slot_finish"] < engine_lib.INF / 2)
    resp = torch.where(done, sim["slot_finish"] - sim["slot_submit"], 0.0)
    n_done = torch.clamp(done.sum(-1), min=1)
    cost = resp.sum(-1) / n_done                             # (B,)
    ent_sum = ents.sum(0)                                    # (B,)
    # per-element columns whose global means are the baseline and the aux
    means = {"entropy": ent_sum.detach(),
             "completed": done.sum(-1).to(torch.float32),
             "shed": sim["shed"].to(torch.float32)}
    if cfg.slo > 0:
        violations = ((done & (resp > cfg.slo)).sum(-1)
                      + (committed & ~done).sum(-1)
                      + sim["shed"] + sim["dropped"])
        total = torch.clamp(committed.sum(-1) + sim["shed"] + sim["dropped"],
                            min=1)
        viol_frac = violations.to(torch.float32) / total
        cost = cost + cfg.slo_penalty * viol_frac
        means["slo_violation_frac"] = viol_frac
    if cfg.deadline_penalty > 0:
        finite = committed & (sim["slot_deadline"] < engine_lib.INF / 2)
        missed = finite & (~done
                           | (sim["slot_finish"] > sim["slot_deadline"]))
        miss_frac = (missed.sum(-1).to(torch.float32)
                     / torch.clamp(finite.sum(-1), min=1))
        cost = cost + cfg.deadline_penalty * miss_frac
        means["deadline_miss_frac"] = miss_frac
    means["cost_mean"] = cost
    aux = _global_means(means, cost.min(), group)
    adv = cost - aux["cost_mean"]

    reinforce = logps.sum(0) * adv.detach()                  # (B,)
    loss = torch.mean(cfg.c1 * reinforce) - cfg.c2 * torch.mean(ent_sum)
    return loss, aux


def _global_means(columns: dict, best, group) -> dict:
    """Means over the global batch of (B,) per-element columns, plus
    ``cost_best`` (``best``, this block's min, reduced with MIN): the
    column sums and the row count go through one SUM all-reduce over
    ``group`` (nothing without one). Detached. The keys come out in the
    reference's aux order."""
    stacked = torch.stack([v.detach() for v in columns.values()], 1)
    sums = torch.cat([stacked.sum(0), stacked.new_full((1,),
                                                       stacked.shape[0])])
    best = best.detach()
    if group is not None:
        dist.all_reduce(sums, group=group)
        dist.all_reduce(best, op=dist.ReduceOp.MIN, group=group)
    mean = dict(zip(columns, sums[:-1] / sums[-1]))
    order = ("slo_violation_frac", "deadline_miss_frac", "cost_mean")
    out = {k: mean[k] for k in order if k in mean}
    out["cost_best"] = best
    out.update({k: mean[k] for k in ("entropy", "completed", "shed")})
    return out


def temporal_loss_and_grads(policy: CoRaiSPolicy, sim_state: dict,
                            arrivals: dict, cfg: TemporalRLConfig, **kw):
    """:func:`temporal_rl_loss` and its gradients as (loss, aux,
    {"/"-path: gradient}), detached."""
    return _grads(policy, *temporal_rl_loss(policy, sim_state, arrivals, cfg,
                                            **kw))


def _group_mean(loss, grads: dict, group):
    """The loss and every gradient averaged over ``group``: one flat
    buffer, one SUM all-reduce, divided by the group's size."""
    keys = list(grads)
    flat = torch.cat([loss.reshape(1)] + [grads[k].reshape(-1) for k in keys])
    dist.all_reduce(flat, group=group)
    flat = flat / dist.get_world_size(group)
    parts = torch.split(flat, [1] + [grads[k].numel() for k in keys])
    return parts[0].reshape(()), {k: p.reshape(grads[k].shape)
                                  for k, p in zip(keys, parts[1:])}


def _temporal_update(policy: CoRaiSPolicy, opt_state: dict, sim_state: dict,
                     arrivals: dict, cfg: TemporalRLConfig,
                     adam_cfg: AdamConfig, *, group=None, **kw):
    """One REINFORCE update (loss -> grads -> clip -> Adam), the policy's
    parameters updated in place. Shared by the per-batch step and the
    epoch step. With ``group`` (the data-parallel trainer) the batch is
    this rank's block, and the loss and the gradients are averaged over
    the group before the clip, so every rank takes the same clip and Adam
    step. Returns (opt_state, metrics), metrics device scalars."""
    loss, aux, grads = temporal_loss_and_grads(policy, sim_state, arrivals,
                                               cfg, group=group, **kw)
    if cfg.freeze_dispatch:
        if not (cfg.admission and any(k.startswith("admit/") for k in grads)):
            raise ValueError(
                "freeze_dispatch requires admission=True and a policy "
                "with admit_head=True (nothing would train otherwise)")
        grads = {k: g if k.startswith("admit/") else torch.zeros_like(g)
                 for k, g in grads.items()}
    if group is not None:
        loss, grads = _group_mean(loss, grads, group)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    opt_state = adam_update(param_tree(policy), grads, opt_state, adam_cfg)
    return opt_state, {"loss": loss, "grad_norm": gnorm, **aux}


def make_temporal_train_step(cfg: TemporalRLConfig,
                             adam_cfg: Optional[AdamConfig] = None):
    """Returns (step, adam_cfg). ``step(policy, opt_state, sim_state,
    arrivals, *, generator=None, actions=None, admits=None) -> (opt_state,
    metrics)``: one update, eagerly, the policy updated in place."""
    adam_cfg = adam_cfg or AdamConfig(lr=cfg.lr)

    def step(policy, opt_state, sim_state, arrivals, **kw):
        return _temporal_update(policy, opt_state, sim_state, arrivals, cfg,
                                adam_cfg, **kw)

    return step, adam_cfg


def resolve_temporal_config(cfg: TemporalRLConfig):
    """Thread the scenario's registered CloudSpec/CacheSpec into the engine
    config and resolve the effective fault spec (``cfg.fault_spec`` wins
    over the registry; a spec with no faults drops to None). Idempotent."""
    ecfg = cfg.engine
    cloud_spec, cache_spec = scenarios_lib.scenario_cloud_spec(cfg.scenario)
    if cloud_spec is not None and ecfg.cloud is None:
        ecfg = dataclasses.replace(ecfg, cloud=cloud_spec, cache=cache_spec)
        cfg = dataclasses.replace(cfg, engine=ecfg)
    fspec = cfg.fault_spec
    if fspec is None:
        fspec = scenarios_lib.scenario_fault_spec(cfg.scenario)
    if fspec is not None and not fspec.has_faults:
        fspec = None
    return cfg, fspec


def _generator(device, seed) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _mesh_shards(mesh, cfg: TemporalRLConfig):
    """(group, index, size) of ``mesh``'s ``"fleet"`` axis; raises when the
    batch does not divide over it."""
    group, index, shards = mesh_axis(mesh, "fleet")
    if cfg.batch_size % shards:
        raise ValueError(
            f"batch_size {cfg.batch_size} does not divide over the "
            f"{shards}-device mesh")
    return group, index, shards


def make_temporal_epoch_step(cfg: TemporalRLConfig,
                             adam_cfg: Optional[AdamConfig] = None, *,
                             mesh=None):
    """Epoch step: K sequential REINFORCE updates per call, with episodes
    (arrivals and fault rows) drawn on the state's device by the device
    samplers, so the host only supplies cluster states and seeds.

    The returned ``step(policy, opt_state, sim0, seeds)`` takes a (K, B,
    ...) stack of initial engine states and (K, 3) integer seeds (the
    arrival, action and fault generators of each update, as
    :func:`_episode_seeds` gives them), and returns ``(opt_state,
    metrics)`` with every metric stacked (K,) on the device: nothing is
    read back until the caller drains them.

    The reference runs the K updates as one ``lax.scan``. A K-update CUDA
    graph is not possible yet: the engine's lane recursion reads its step
    count on the host every round (``serving/engine.py::advance``), so the
    updates run eagerly.

    With ``mesh`` (a :func:`repro_torch.launch.mesh.make_fleet_mesh` mesh)
    the batch is sharded over its ``"fleet"`` axis, data-parallel: every
    rank calls ``step`` with the same arguments (the global ``sim0``, the
    same seeds, a policy with the same parameters), draws each update's
    arrivals, fault rows and action noise for the global batch and keeps
    its contiguous block, and averages the gradients over the mesh before the
    clip (:func:`_temporal_update`). An element's episode and draws are
    then those of the unsharded step, so the result equals it up to float
    reassociation in the reductions, and the parameters stay the same bits
    on every rank. One caveat, the reference's too: an untrained BatchNorm
    (``norm="batch"`` with count 0) takes its fallback statistics over the
    rank's block, not the global batch; exact shard parity holds for
    ``norm="layer"`` and for BatchNorm with running statistics. Raises
    ``ValueError`` when ``cfg.batch_size`` does not divide over the axis."""
    group = None
    if mesh is not None:
        group, index, shards = _mesh_shards(mesh, cfg)
    adam_cfg = adam_cfg or AdamConfig(lr=cfg.lr)
    cfg, fspec = resolve_temporal_config(cfg)
    ecfg = cfg.engine
    wl = scenarios_lib.scenario(cfg.scenario)
    # fail fast on scenarios with no device sampling law
    compile_device_plan(wl, ecfg.num_edges, ecfg.num_rounds,
                        ecfg.round_interval)

    def step(policy, opt_state, sim0, seeds):
        mets = []
        for k, (s_arr, s_act, s_flt) in enumerate(np.asarray(seeds)):
            sim = {name: v[k] for name, v in sim0.items()}
            device = sim["t"].device
            arrivals = materialize_round_batch_device(
                wl, ecfg.num_edges, ecfg.num_rounds, ecfg.round_interval,
                cfg.batch_size, generator=_generator(device, s_arr),
                max_per_round=ecfg.max_per_round)
            if fspec is not None:
                arrivals = faults_lib.attach_fault_batch_device(
                    arrivals, fspec, ecfg.num_edges,
                    _generator(device, s_flt))
            if group is not None:
                if device.type != mesh.device_type:
                    raise ValueError(f"states on {device} but the mesh is "
                                     f"{mesh.device_type!r}")
                sim = local_block(sim, engine_state_specs(sim), index,
                                  shards)
                arrivals = local_block(arrivals, arrival_specs(arrivals),
                                       index, shards)
            opt_state, metrics = _temporal_update(
                policy, opt_state, sim, arrivals, cfg, adam_cfg,
                group=group, generator=_generator(device, s_act))
            mets.append(metrics)
        return opt_state, {k: torch.stack([m[k] for m in mets])
                           for k in mets[0]}

    return step, adam_cfg


#: rng-stream salts deriving per-batch episode randomness from
#: (cfg.seed, batch index), order-free, so a checkpoint resume at any batch
#: replays exactly the stream an uninterrupted run would consume. The first
#: three are the reference's (clusters and host episodes equal its own, bit
#: for bit); the device generators' seeds take the port's own salt.
_CLUSTER_SALT = 0xC1
_ARRIVAL_SALT = 0xA7
_FAULT_SEED_SALT = 0xFA
_GENERATOR_SALT = 0x6E


def _cluster_seeds(cfg: TemporalRLConfig, b: int) -> np.ndarray:
    return np.random.default_rng((cfg.seed, _CLUSTER_SALT, b)).integers(
        0, 2**31 - 1, size=cfg.batch_size)


def _episode_seeds(cfg: TemporalRLConfig, b: int) -> np.ndarray:
    """(3,) seeds of batch ``b``'s device generators: arrivals, actions,
    faults."""
    return np.random.default_rng((cfg.seed, _GENERATOR_SALT, b)).integers(
        0, 2**62, size=3)


def _host_episode(cfg: TemporalRLConfig, fspec, wl, b: int) -> dict:
    """Batch ``b``'s arrivals (and fault rows) from the numpy samplers,
    seeded as the reference seeds them."""
    ecfg = cfg.engine
    # overflow="clip": a burst beyond max_per_round drops its tail in
    # *training* episodes (a bounded admission queue), never in evals
    arrivals = materialize_round_batch(
        wl, ecfg.num_edges, ecfg.num_rounds, ecfg.round_interval,
        cfg.batch_size,
        base_seed=int(np.random.default_rng(
            (cfg.seed, _ARRIVAL_SALT, b)).integers(0, 2**31 - 1)),
        max_per_round=ecfg.max_per_round, overflow="clip")
    if fspec is not None:
        arrivals = faults_lib.attach_fault_batch(
            arrivals, fspec, ecfg.num_edges,
            seeds=np.random.default_rng(
                (cfg.seed, _FAULT_SEED_SALT, b)).integers(
                    0, 2**31 - 1, size=cfg.batch_size))
    return arrivals


def temporal_train(
    cfg: TemporalRLConfig,
    num_batches: Optional[int] = None,
    policy: Optional[CoRaiSPolicy] = None,
    opt_state: Optional[dict] = None,
    callback: Optional[Callable] = None,
    *,
    mesh=None,
    checkpointer=None,
    start_batch: int = 0,
    adam_cfg: Optional[AdamConfig] = None,
    device=None,
):
    """Train CoRaiS on temporal rollouts of a registered workload scenario.

    Every batch samples ``batch_size`` fresh clusters and arrival episodes,
    rolls all of them forward together on the device, and applies one
    REINFORCE update on the episode returns. Returns (policy, opt_state,
    history); each history row holds the reference's keys (the update's
    metrics, ``batch`` and ``sec``). Runs on CUDA unless ``device`` says
    otherwise (a given policy brings its own device).

    Two paths share one update rule (:func:`_temporal_update`):

    * host loop (``device_episodes=False``, ``epoch_len<=1``): one update
      per batch on episodes from the numpy samplers, which equal the
      reference's bit for bit; metrics stay on the device and drain every
      ``log_every`` batches;
    * epoch (``device_episodes=True``, ``epoch_len>1`` or ``mesh=``):
      :func:`make_temporal_epoch_step`, K updates per call with episodes
      drawn on the device, the batch sharded data-parallel over
      ``mesh``'s ``"fleet"`` axis when one is given; ``callback`` then
      fires once per drained epoch (with that epoch's last row), not per
      batch.

    Clusters, episodes and action draws derive from ``(cfg.seed, batch
    index)`` rather than a consumed stream, so resuming from a
    ``checkpointer`` snapshot at any batch replays exactly what the
    uninterrupted run would have drawn: save -> resume is bit-identical.
    With ``checkpointer`` set and no ``policy`` given, the policy and
    optimizer state restore from its latest snapshot (saved under step =
    number of completed batches).

    With ``mesh`` every rank of it runs ``temporal_train`` with the same
    arguments and policy parameters; every rank gets the same history and
    the same callback rows, only the mesh's first rank writes checkpoints
    (the others wait for its last one before returning), and a resume
    restores on every rank. ``cfg.batch_size`` must divide over the mesh
    (``ValueError`` otherwise); see :func:`make_temporal_epoch_step` for
    the BatchNorm caveat."""
    cfg, fspec = resolve_temporal_config(cfg)
    writer, group = True, None
    if mesh is not None:
        group, index, _ = _mesh_shards(mesh, cfg)
        writer = index == 0
    num_batches = num_batches if num_batches is not None else cfg.num_batches
    ecfg = cfg.engine
    wl = scenarios_lib.scenario(cfg.scenario)
    adam_cfg = adam_cfg or AdamConfig(lr=cfg.lr)
    if policy is None:
        policy = CoRaiSPolicy(cfg.policy,
                              generator=torch.Generator().manual_seed(cfg.seed),
                              device=resolve_device(device))
        restored = (checkpointer.restore_latest() if checkpointer is not None
                    else None)
        if restored is not None:
            opt_state = load_train_state(policy, restored["tree"])
            start_batch = int(restored["step"])
    device = policy.device
    if opt_state is None:
        opt_state = adam_init(param_tree(policy), adam_cfg)

    use_epoch = cfg.device_episodes or cfg.epoch_len > 1 or mesh is not None
    end = start_batch + num_batches
    history: list = []
    pending: list = []  # (batch ids, sec per batch, device metrics)

    def drain():
        rows = []
        for bs, sec, mets in pending:
            host = {k: v.detach().cpu().numpy() for k, v in mets.items()}
            for i, b_i in enumerate(bs):
                row = {k: float(v[i]) if v.ndim else float(v)
                       for k, v in host.items()}
                row["batch"], row["sec"] = b_i, sec
                history.append(row)
                rows.append(row)
        pending.clear()
        return rows

    def save(step_idx):
        if (writer and checkpointer is not None
                and checkpointer.should_save(step_idx)):
            checkpointer.save(step_idx, train_tree(policy, opt_state))

    if not use_epoch:
        step_fn, _ = make_temporal_train_step(cfg, adam_cfg)
        for b in range(start_batch, end):
            sim0 = engine_lib.init_batch(ecfg, _cluster_seeds(cfg, b),
                                         device=device)
            arrivals = engine_lib._to_device(
                _host_episode(cfg, fspec, wl, b), device)
            t0 = time.perf_counter()
            opt_state, metrics = step_fn(
                policy, opt_state, sim0, arrivals,
                generator=_generator(device, _episode_seeds(cfg, b)[1]))
            pending.append(([b], time.perf_counter() - t0, metrics))
            # metrics stay on the device between drains
            if b % cfg.log_every == 0 or b == end - 1:
                rows = drain()
                if callback is not None and rows and b % cfg.log_every == 0:
                    callback(rows[-1])
            save(b + 1)
        drain()
        if checkpointer is not None:
            checkpointer.wait()  # a caller may read the checkpoint on return
        return policy, opt_state, history

    step_fn, _ = make_temporal_epoch_step(cfg, adam_cfg, mesh=mesh)
    epoch_len = max(1, cfg.epoch_len)
    b = start_batch
    while b < end:
        k_len = min(epoch_len, end - b)
        if checkpointer is not None:
            # land chunk boundaries exactly on checkpoint steps so a resume
            # replays the same chunking (bit-identical histories)
            k_len = min(k_len, checkpointer.every - b % checkpointer.every)
        bs = list(range(b, b + k_len))
        sim0 = engine_lib.init_batch(
            ecfg, np.concatenate([_cluster_seeds(cfg, bi) for bi in bs]),
            device=device)
        sim0 = {k: v.reshape(k_len, cfg.batch_size, *v.shape[1:])
                for k, v in sim0.items()}
        seeds = np.stack([_episode_seeds(cfg, bi) for bi in bs])
        t0 = time.perf_counter()
        opt_state, mets = step_fn(policy, opt_state, sim0, seeds)
        pending.append((bs, (time.perf_counter() - t0) / k_len, mets))
        b += k_len
        n_pending = sum(len(p[0]) for p in pending)
        if callback is not None or n_pending >= cfg.log_every or b >= end:
            rows = drain()
            if callback is not None and rows:
                callback(rows[-1])  # per-epoch logging
        save(b)
    drain()
    if checkpointer is not None:
        checkpointer.wait()
        if group is not None:
            # the other ranks return once the writer's last save landed
            flag = torch.zeros(1, device=device)
            dist.all_reduce(flag, group=group)
            flag.item()
    return policy, opt_state, history
