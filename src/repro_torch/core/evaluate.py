"""Evaluation harness: gaps vs. the reference solver (paper §V, eq 22) on
static instances; counterpart of the static half of
``repro/core/evaluate.py``. Rollout evaluation on the batched engine is not
ported yet."""
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
    shared decision path (core.inference) on the policy's device, timed
    from host arrays to host assignment."""
    decide = make_decision_fn(policy, DecisionSpec(mode=mode, num_samples=n,
                                                   backend=backend))
    device = policy.device
    gen = torch.Generator(device=device).manual_seed(seed)

    def run(inst):
        t0 = time.perf_counter()
        tinst = {k: torch.as_tensor(np.asarray(v)).to(device)
                 for k, v in inst.items()}
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
