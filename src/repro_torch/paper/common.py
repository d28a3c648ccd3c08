"""Shared pieces of the paper's evaluation: the cached policy trainers and
the instance set; counterpart of ``benchmarks/common.py``.

Scale note (the reference's documented deviation): the paper trains 40k
batches of 128 instances; the evaluation trains a few hundred to a thousand
batches at lr 3e-4 (instead of 1e-5) on the same instance distribution.
The qualitative ordering (CoRaiS ~ REF << Random/Local, real-time
decisions) is what the evaluation checks.

A getter returns ``(policy, cfg)``: a :class:`CoRaiSPolicy` on the
requested device (the card unless ``device="cpu"``) and its training
config, in place of the reference's ``(params, state, cfg)``. Policies are
cached under :data:`RESULTS` with the reference's tags, trees and
checkpoint format (``arrays.npz`` + ``manifest.json``), so either package
loads the other's cached policy.
"""
from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import Checkpointer, train_tree
from repro_torch.checkpoint.convert import load_reference_params
from repro_torch.core.instances import InstanceConfig, generate_instance
from repro_torch.core.policy import (EDGE_FEATURES, REQ_FEATURES,
                                     CoRaiSPolicy, PolicyConfig)
from repro_torch.core.train import (RLConfig, TemporalRLConfig,
                                    temporal_train, train)
from repro_torch.nn.module import param_tree, state_tree
from repro_torch.optim import AdamConfig, adam_init
from repro_torch.serving.engine import EngineConfig

#: the cache of trained policies: ``<repo>/results/torch/<tag>/`` (git-ignored)
RESULTS = str(Path(__file__).resolve().parents[3] / "results" / "torch")
POLICY_DIM = 128  # evaluation-scale policy (the paper's is 256)


def rl_config(en: int, rn: int, batches: int, d_model: int = POLICY_DIM,
              lr: float = 3e-4) -> RLConfig:
    return RLConfig(
        policy=PolicyConfig(d_model=d_model),
        instance=InstanceConfig(num_edges=en, num_requests=rn),
        batch_size=32,
        num_samples=32,
        lr=lr,
        num_batches=batches,
        seed=0,
    )


def _fresh(pcfg: PolicyConfig, seed: int, device) -> CoRaiSPolicy:
    """The policy a trainer starts from (its seeded initialization)."""
    return CoRaiSPolicy(pcfg, generator=torch.Generator().manual_seed(seed),
                        device=device)


def _checkpointer(tag: str) -> Checkpointer:
    return Checkpointer(os.path.join(RESULTS, tag), every=10**9,
                        async_save=False)


def _load_cached(ckpt: Checkpointer, policy: CoRaiSPolicy,
                 with_opt: bool = False) -> bool:
    """Load the latest checkpoint's ``params`` and ``state`` into ``policy``;
    False when there is none. The template is the reference's tree
    (``opt_state`` too with ``with_opt``): a missing leaf raises
    ``KeyError`` and a shape mismatch ``ValueError``, as the reference's
    ``restore_latest`` does."""
    opt = (adam_init(param_tree(policy), AdamConfig()) if with_opt else None)
    restored = ckpt.restore_latest(train_tree(policy, opt))
    if restored is None:
        return False
    tree = restored["tree"]
    load_reference_params(policy, tree["params"], tree["state"])
    return True


def _report(kind: str, tag: str, batches: int, t0: float, hist: list,
            verbose: bool) -> None:
    if verbose:
        print(f"# {kind} {batches} batches in {time.time() - t0:.1f}s "
              f"(cost {hist[0]['cost_mean']:.3f} -> "
              f"{hist[-1]['cost_mean']:.3f}) [{tag}]")


def get_trained_policy(en: int = 5, rn: int = 50, batches: int = 800,
                       d_model: int = POLICY_DIM, verbose: bool = True,
                       device=None):
    """Train (or load cached) a CoRaiS policy for scale (EN, RN)."""
    device = resolve_device(device)
    cfg = rl_config(en, rn, batches, d_model)
    tag = f"policy_en{en}_rn{rn}_d{d_model}_b{batches}"
    ckpt = _checkpointer(tag)
    policy = _fresh(cfg.policy, cfg.seed, device)
    if _load_cached(ckpt, policy, with_opt=True):
        if verbose:
            print(f"# loaded cached policy {tag}")
        return policy, cfg

    t0 = time.time()
    cb = (lambda m: print(f"#   batch {m['batch']} cost {m['cost_mean']:.3f}")) \
        if verbose else None
    policy, opt_state, hist = train(cfg, policy=policy, callback=cb)
    _report("trained", tag, batches, t0, hist, verbose)
    ckpt.save(batches, train_tree(policy, opt_state))
    ckpt.wait()
    return policy, cfg


def _temporal_policy(cfg: TemporalRLConfig, tag: str, device, label: str,
                     verbose: bool, warm_start=None, log=None):
    """Load the cached policy under ``tag``, or make the seeded one, let
    ``warm_start(policy)`` set its weights, train it with
    ``temporal_train`` and cache ``{"params", "state"}``."""
    ckpt = _checkpointer(tag)
    policy = _fresh(cfg.policy, cfg.seed, device)
    if _load_cached(ckpt, policy):
        if verbose:
            print(f"# loaded cached {label} policy {tag}")
        return policy, cfg
    if warm_start is not None:
        warm_start(policy)
    t0 = time.time()
    cb = None
    if verbose:
        def cb(m):
            print(f"#   epoch to batch {m['batch']} cost {m['cost_mean']:.3f}"
                  + (log(m) if log is not None else ""))
    policy, _, hist = temporal_train(cfg, policy=policy, callback=cb)
    _report(f"{label}-trained", tag, cfg.num_batches, t0, hist, verbose)
    ckpt.save(cfg.num_batches, train_tree(policy))
    ckpt.wait()
    return policy, cfg


def get_temporal_policy(en: int = 5, batches: int = 200,
                        d_model: int = POLICY_DIM,
                        scenario_name: str = "uniform_iid",
                        verbose: bool = True, device=None):
    """Train (or load cached) a CoRaiS policy with temporal REINFORCE on
    whole engine rollouts (``core.train.temporal_train``): the counterpart
    of :func:`get_trained_policy`'s static i.i.d. snapshots, for the
    policy-vs-baseline rollout comparison."""
    cfg = TemporalRLConfig(
        policy=PolicyConfig(d_model=d_model),
        engine=EngineConfig(num_edges=en),
        scenario=scenario_name,
        batch_size=8,
        lr=3e-4,
        num_batches=batches,
        seed=0,
        # the epoch trainer: episodes drawn on the device, 25 updates a
        # call, metrics drained (and logged) once per epoch
        device_episodes=True,
        epoch_len=25,
    )
    tag = f"policy_temporal_en{en}_d{d_model}_b{batches}_{scenario_name}"
    return _temporal_policy(cfg, tag, resolve_device(device), "temporal",
                            verbose)


def _copy_from(policy: CoRaiSPolicy, source: CoRaiSPolicy, skip=()) -> None:
    """Copy ``source``'s parameters and norm state into ``policy`` in place,
    leaving the parameters under the ``skip`` prefixes as they are."""
    src_params, src_state = param_tree(source), state_tree(source)
    with torch.no_grad():
        for k, p in param_tree(policy).items():
            if not k.startswith(tuple(skip)):
                p.copy_(src_params[k])
        for k, b in state_tree(policy).items():
            b.copy_(src_state[k])


def get_resilient_policy(en: int = 5, batches: int = 300,
                         d_model: int = POLICY_DIM,
                         scenario_name: str = "chaos-rolling-failure",
                         slo: float = 3.0, slo_penalty: float = 10.0,
                         verbose: bool = True, device=None):
    """Train (or load cached) the admission head of a CoRaiS policy on
    fault-injected rollouts of a chaos scenario: the policy-with-admission
    column of the resilience fault matrix.

    The dispatch weights warm-start from the static-trained policy
    (:func:`get_trained_policy` at 800 batches) and stay frozen
    (``freeze_dispatch=True``), so the fault matrix measures what
    admission adds on identical dispatch. Only the admit head (fresh, bias
    1.0) trains, against episode cost ``mean_response + slo_penalty *
    slo_violation_frac``, where sheds and drops count as violations."""
    device = resolve_device(device)
    cfg = TemporalRLConfig(
        policy=PolicyConfig(d_model=d_model, admit_head=True,
                            admit_bias=1.0),
        # overload scenarios outrun the default 16-wide admission queue
        engine=EngineConfig(num_edges=en, max_per_round=64),
        scenario=scenario_name,
        batch_size=8,
        lr=1e-3,
        num_batches=batches,
        seed=0,
        admission=True,
        slo=slo,
        slo_penalty=slo_penalty,
        freeze_dispatch=True,
        device_episodes=True,
        epoch_len=25,
    )
    tag = (f"policy_resilient_admit_en{en}_d{d_model}_b{batches}_"
           f"{scenario_name}")

    def warm_start(policy):
        static, _ = get_trained_policy(en, 50, 800, d_model=d_model,
                                       verbose=verbose, device=device)
        _copy_from(policy, static, skip=("admit/",))

    return _temporal_policy(cfg, tag, device, "resilient (admit head)",
                            verbose, warm_start,
                            log=lambda m: f" shed {m['shed']:.1f}")


def get_cloud_policy(en: int = 5, batches: int = 300,
                     d_model: int = POLICY_DIM,
                     scenario_name: str = "cloud-cache-churn",
                     deadline_penalty: float = 8.0, verbose: bool = True,
                     device=None):
    """Train (or load cached) the deadline/cache-aware CoRaiS policy for an
    edge-cloud scenario: the ``batched-corais-cloud`` column of the
    scenario sweep.

    Tier features are on (``PolicyConfig(tier_features=True)``) and the
    episode cost adds ``deadline_penalty * deadline_miss_frac``. The
    weights warm-start from the static-trained flat-tier policy: the
    static edge and request projections fill the first ``EDGE_FEATURES``
    and ``REQ_FEATURES`` rows and the tier rows start at zero, so at batch
    0 the policy scores nodes exactly like the cache-oblivious
    ``batched-corais`` column."""
    device = resolve_device(device)
    cfg = TemporalRLConfig(
        policy=PolicyConfig(d_model=d_model, tier_features=True),
        # deadline-heavy scenarios burst past the default admission width
        engine=EngineConfig(num_edges=en, max_per_round=64),
        scenario=scenario_name,
        batch_size=8,
        lr=1e-3,
        num_batches=batches,
        seed=0,
        deadline_penalty=deadline_penalty,
        device_episodes=True,
        epoch_len=25,
    )
    tag = f"policy_cloud_en{en}_d{d_model}_b{batches}_{scenario_name}"

    def warm_start(policy):
        static, _ = get_trained_policy(en, 50, 800, d_model=d_model,
                                       verbose=verbose, device=device)
        _copy_from(policy, static, skip=("edge_proj/w", "req_proj/w"))
        with torch.no_grad():
            for name, base in (("edge_proj", EDGE_FEATURES),
                               ("req_proj", REQ_FEATURES)):
                w = getattr(policy, name).w
                w.zero_()
                w[:base].copy_(getattr(static, name).w)

    return _temporal_policy(
        cfg, tag, device, "cloud", verbose, warm_start,
        log=lambda m: f" dl_miss {m.get('deadline_miss_frac', 0.0):.3f}")


def eval_instances(en: int, rn: int, n: int, seed: int = 999):
    rng = np.random.default_rng(seed)
    return [generate_instance(rng, InstanceConfig(num_edges=en,
                                                  num_requests=rn))
            for _ in range(n)]


def csv_line(name: str, us_per_call: float, derived: str) -> str:
    return f"{name},{us_per_call:.1f},{derived}"

