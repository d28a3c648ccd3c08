"""Evaluation harness: gaps vs. the reference solver (paper §V, eq 22) on
static instances, plus temporal rollout evaluation on the batched engine;
counterpart of ``repro/core/evaluate.py``."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.heuristics import solve_ils, solve_local, solve_random
from repro_torch.core.inference import DecisionSpec, make_decision_fn
from repro_torch.core.objective import makespan_np
from repro_torch.core.policy import CoRaiSPolicy
from repro_torch.serving import engine as engine_lib
from repro_torch.workloads.batch import materialize_round_batch


@dataclasses.dataclass
class MethodResult:
    name: str
    mean_time_s: float
    mean_cost: float
    mean_gap: float
    solved_frac: float = 1.0


def _policy_method(policy: CoRaiSPolicy, mode: str, n: int, seed: int,
                   backend: Optional[str] = None):
    """Returns fn(inst) -> (assign, solve_time) over numpy instances: the
    shared decision path (core.inference) on the policy's device. The
    instance is staged on the device before the clock starts, as the
    reference stages it with ``jnp.asarray`` first, so ``solve_time`` runs
    from the staged instance to the host assignment."""
    decide = make_decision_fn(policy, DecisionSpec(mode=mode, num_samples=n,
                                                   backend=backend))
    device = policy.device
    gen = torch.Generator(device=device).manual_seed(seed)

    def run(inst):
        tinst = {k: torch.as_tensor(np.asarray(v)).to(device)
                 for k, v in inst.items()}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        assign = decide(tinst, generator=gen).cpu().numpy()
        return assign, time.perf_counter() - t0

    return run


def evaluate_methods(
    instances: list,
    methods: dict[str, Callable],
    reference: str,
) -> dict[str, MethodResult]:
    """Run every method on every instance; gap_b = L(pi|b) / L(pi|REF)."""
    per_method_costs: dict[str, list[float]] = {m: [] for m in methods}
    per_method_times: dict[str, list[float]] = {m: [] for m in methods}
    for inst in instances:
        for name, fn in methods.items():
            t0 = time.perf_counter()
            out = fn(inst)
            if isinstance(out, tuple):
                assign, dt = out
            else:
                assign, dt = out, time.perf_counter() - t0
            per_method_costs[name].append(makespan_np(inst, assign))
            per_method_times[name].append(dt)

    ref_costs = np.asarray(per_method_costs[reference])
    results = {}
    for name in methods:
        costs = np.asarray(per_method_costs[name])
        gaps = costs / np.maximum(ref_costs, 1e-9)
        results[name] = MethodResult(
            name=name,
            mean_time_s=float(np.mean(per_method_times[name])),
            mean_cost=float(np.mean(costs)),
            mean_gap=float(np.mean(gaps)),
        )
    return results


def standard_method_suite(
    policy: Optional[CoRaiSPolicy] = None,
    ref_budget_s: float = 1.0,
    random_ns=(1, 100, 1000),
    sample_ns=(100, 1000),
):
    """The paper's Table II method set, minus Gurobi (ILS is the
    time-budgeted reference)."""
    methods: dict[str, Callable] = {}
    methods[f"ILS({ref_budget_s}s)"] = lambda inst: solve_ils(inst, budget_s=ref_budget_s)
    methods["Local"] = solve_local
    for n in random_ns:
        methods[f"Random({n})"] = (lambda n_: lambda inst: solve_random(inst, n_, seed=0))(n)
    if policy is not None:
        methods["CoRaiS(greedy)"] = _policy_method(policy, "greedy", 0, seed=0)
        for n in sample_ns:
            methods[f"CoRaiS({n})"] = _policy_method(policy, "sample", n, seed=n)
    return methods


# ---------------------------------------------------------------------------
# Temporal evaluation: backends compared on whole engine rollouts
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RolloutResult:
    """Aggregate of one backend over a batch of engine rollouts."""

    name: str
    completed: int
    submitted: int
    mean_response: float
    p95_response: float
    makespan: float
    wall_s: float          # the whole batch's rollout, warm-up excluded
    metrics: dict = dataclasses.field(default_factory=dict)


def evaluate_rollouts(
    assign_fns: dict,
    cfg: engine_lib.EngineConfig,
    workload,
    *,
    batch: int = 8,
    base_seed: int = 0,
    seed: int = 0,
    device=None,
) -> dict[str, RolloutResult]:
    """Run every scheduling backend over the same ``batch`` scenario
    episodes (paired clusters and arrival streams) on the batched engine;
    the temporal counterpart of :func:`evaluate_methods`.

    ``assign_fns`` values may be AssignFns (e.g. from
    ``engine.make_policy_assign``) or registered engine backend names.
    Each backend runs once untimed (kernel builds, first-call costs), then
    once timed to a device synchronisation; sampled dispatch draws from a
    generator seeded with ``seed`` on the state's device."""
    arrivals = materialize_round_batch(
        workload, cfg.num_edges, cfg.num_rounds, cfg.round_interval, batch,
        base_seed=base_seed)
    state0 = engine_lib.init_batch(cfg, range(base_seed, base_seed + batch),
                                   device=device)
    dev = state0["t"].device
    results = {}
    for name, fn in assign_fns.items():
        if isinstance(fn, str):
            fn = engine_lib.resolve_assign_fn(fn)
        run = engine_lib.make_rollout(cfg, fn, batch=True)
        run(state0, arrivals, torch.Generator(device=dev).manual_seed(seed))
        _sync(dev)
        t0 = time.perf_counter()
        final, _ = run(state0, arrivals,
                       torch.Generator(device=dev).manual_seed(seed))
        _sync(dev)
        wall = time.perf_counter() - t0
        m = engine_lib.summarize(final)
        results[name] = RolloutResult(
            name=name,
            completed=m["completed"],
            submitted=m["submitted"],
            mean_response=m["mean_response"],
            p95_response=m["p95_response"],
            makespan=m["makespan"],
            wall_s=wall,
            metrics=m,
        )
    return results


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
