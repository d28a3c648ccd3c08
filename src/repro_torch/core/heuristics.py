"""Non-learning baselines (paper §V-A) plus the time-budgeted reference: a
numpy copy of ``repro/core/heuristics.py``, equal to it bit for bit.

* :func:`solve_local`   — every request executes at its source edge.
* :func:`solve_random`  — best of n uniform assignments (Random(n)).
* :func:`solve_greedy`  — size-descending greedy insertion (ours; also the
  serving controller's fallback when no policy checkpoint is loaded).
* :func:`solve_ils`     — iterated local search with a wall-clock budget.
  It stands in for the paper's Gurobi(x s): it is what gaps are computed
  against (labelled REF, never "optimal").

All operate on a single (optionally padded) instance in numpy.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.objective import makespan_np


def _real_indices(inst):
    zs = np.nonzero(np.asarray(inst["req_mask"]))[0]
    qs = np.nonzero(np.asarray(inst["edge_mask"]))[0]
    return zs, qs


def solve_local(inst) -> np.ndarray:
    return np.asarray(inst["req_src"], np.int32).copy()


def solve_random(inst, num_samples: int = 1, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    zs, qs = _real_indices(inst)
    best, best_cost = None, np.inf
    assign = solve_local(inst)
    for _ in range(num_samples):
        cand = assign.copy()
        cand[zs] = rng.choice(qs, size=len(zs))
        cost = makespan_np(inst, cand)
        if cost < best_cost:
            best, best_cost = cand, cost
    return best


def solve_greedy(inst) -> np.ndarray:
    """Assign requests in decreasing data size, each to the edge that
    minimizes the incremental makespan."""
    zs, qs = _real_indices(inst)
    sizes = np.asarray(inst["req_size"])
    order = zs[np.argsort(-sizes[zs])]
    assign = solve_local(inst)
    assign[zs] = -1
    # makespan_np ignores unassigned only if we park them somewhere valid:
    # build up incrementally instead.
    cur = solve_local(inst)
    for z in order:
        best_q, best_cost = None, np.inf
        for q in qs:
            cur_z = cur[z]
            cur[z] = q
            # evaluate with all later (not-yet-decided) requests at source
            cost = makespan_np(inst, cur)
            cur[z] = cur_z
            if cost < best_cost:
                best_q, best_cost = q, cost
        cur[z] = best_q
    return cur


def _local_search(inst, assign, zs, qs, deadline) -> tuple[np.ndarray, float]:
    """Best-improvement single-request moves until a local optimum."""
    cost = makespan_np(inst, assign)
    improved = True
    while improved and time.perf_counter() < deadline:
        improved = False
        for z in zs:
            if time.perf_counter() >= deadline:
                break
            cur_q = assign[z]
            best_q, best_cost = cur_q, cost
            for q in qs:
                if q == cur_q:
                    continue
                assign[z] = q
                c = makespan_np(inst, assign)
                if c < best_cost - 1e-12:
                    best_q, best_cost = q, c
            assign[z] = best_q
            if best_q != cur_q:
                cost = best_cost
                improved = True
    return assign, cost


def solve_ils(inst, budget_s: float = 1.0, seed: int = 0,
              perturb_frac: float = 0.15) -> np.ndarray:
    """Iterated local search: greedy start, then (perturb -> local search)
    restarts keeping the best, until the wall-clock budget expires."""
    rng = np.random.default_rng(seed)
    zs, qs = _real_indices(inst)
    deadline = time.perf_counter() + budget_s
    assign = solve_greedy(inst)
    assign, cost = _local_search(inst, assign, zs, qs, deadline)
    best, best_cost = assign.copy(), cost
    k = max(1, int(perturb_frac * len(zs)))
    while time.perf_counter() < deadline:
        cand = best.copy()
        moved = rng.choice(zs, size=min(k, len(zs)), replace=False)
        cand[moved] = rng.choice(qs, size=len(moved))
        cand, cost = _local_search(inst, cand, zs, qs, deadline)
        if cost < best_cost - 1e-12:
            best, best_cost = cand.copy(), cost
    return best


SOLVERS = {
    "local": solve_local,
    "greedy": solve_greedy,
}
